"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the root of the repository:

    python3 chip_smoke.py

Phases (each one fails the run on error; nothing is caught and swallowed).
Every phase that trains through ``Trainer.train_epoch`` or
``Trainer.test_epoch`` runs those epochs as CUDA graphs (the port's
``train.scan_epoch``, unset means on; ``scrubvae_torch.train.graph``); a
kernel wrapper's ``launches`` counts the launches a graph recorded once at
each replay, so the launch checks below read the same counts as eager
steps would give them (the graph phase holds the two equal).

1. card: print the GPU's name and power limit (nvidia-smi); TF32 off.
2. build: compile every hand-written kernel from ``scrubvae_torch/csrc``.
3. kernel: the fused AdamW kernel against its plain PyTorch version, bitwise
   in all four dtype variants at two shapes, both with injected noise and
   on the Philox path; stochastic rounding unbiased; its time beside the
   plain version's, ``torch._fused_adamw_``'s and the bandwidth bound, and
   the bf16 variant's Philox time beside its injected-noise time. Then the
   flagship's whole leaf set (130 leaves, 53,308,812 elements, at their
   shapes and dtypes) in one multi-tensor call, bitwise against the plain
   version on the Philox path, and that pass's time beside its bound and
   ``torch._fused_adamw_`` over f32 copies of every leaf.
4. parity: one small train step on the GPU against the same step on the CPU
   (same weights, same sample noise), held to the step-1 bounds of
   ``scrubvae_torch.train.parity``; the GPU runs it twice with deterministic
   algorithms, and the two runs must be bitwise equal.
5. path: the flagship train step at full width (channels 64-1024, window 51,
   z 128, batch 512, bf16) for 3 warm-up and 20 timed steps through
   ``factory.build_model`` and ``Trainer``; losses finite, and the
   optimizer's leaf table covering all 130 leaves with one kernel launch
   per dtype variant (2) a step; then the optimizer pass alone beside the
   bytes it must move.
6. profile, only when asked for (``--phases kernel,parity,path,profile``):
   device time by kernel over 5 flagship steps, and the device's idle share
   (torch.profiler; the table goes to ``build/profile_path.txt``); then
   ``python -m scrubvae_torch.profile_step``'s line, eagerly and in a
   graph (20 steps each), for the flagship, ``configs/ladder/5_full.yaml``,
   ``configs/sane/4_full.yaml`` and the flagship's config with the
   transformer, each with its counted step's bytes and bound (required
   > 0 and, the bound, at most the profiled device-busy time a step) and
   its table by operator class in ``build/``.
7. fit: the training entry point at full flagship width. A YAML config
   (the path phase's flagship, epochs 11 to 20 from ``model.start_epoch``
   10 with nothing loaded, validation from epoch 0, without
   ``minimal_test``, so decodability runs) is read by
   ``scrubvae_torch.params.read.config`` and trained by
   ``scrubvae_torch.train.trainer.train`` on synthetic splits built in
   memory (train: 4 ids, at least 3 steps an epoch at batch 512; val: 4 ids
   x 2600 frames, 5100 windows, so 100 rows for the regression folds and
   1020 for the classification folds, and a partial tail batch).
   ``metrics.csv`` must hold 10 rows with a finite ``total_train``, the
   validation losses and finite generative-restrictiveness R^2 at epochs 15
   and 20, and there every decodability column (linear and MLP R^2 of
   avg_speed_3d and heading, logistic and QDA accuracy of the ids) finite,
   with no ``*_nanfolds`` column: a failed fold prints its exception, saves
   that mu to ``chiprun_out/`` and fails the phase. Weights at those epochs
   and the full state at 20; 2 optimizer launches a step over a table of
   all 130 leaves, epoch after epoch of GR re-init. Then the epoch-20
   validation mu and labels go through the decodability estimators on the
   card and on the CPU: the same folds, linear R^2 within 1e-9 (float64),
   QDA and LDA predictions identical, logistic predictions within one
   sample a fold, MLP R^2 within 1e-3 from the same CPU-drawn init. Then a
   resume from epoch 20 (``model.load_model``, ``start_epoch``) must
   restore parameters, moments, step counts, MALS state and generator
   state bit for bit as the first run held them, and epoch 21 must train
   with finite losses. Prints the epoch, step, validation, decodability (by
   probe), save and restore times and the peak memory beside the card's
   name and power limit. The card's machine has no ``h5py`` and no
   ``sklearn``, so this phase builds its splits in memory; the route through
   pose files on disk and the ``python -m scrubvae_torch.train_model`` CLI,
   and the estimators against the JAX package's sklearn ones, are covered
   by the tests on the CPU (``tests/test_torch_port_checkpoint.py``,
   ``tests/test_torch_port_fit.py``, ``tests/test_torch_port_decodability.py``).
8. full: the full scrubber stack of ``configs/ladder/5_full.yaml`` (QDA on
   ids; linear, MALS, gradient-reversal and adversarial scrubbers on
   avg_speed_3d; mcmi and total correlation, so the dense Cholesky head).
   First steps 1 and 2 on the card against the CPU from the seed's weights
   and states with the same rows, noise and shuffles, at narrow channels, z
   128, batch 16, f32, without clip: step 1 held to
   ``scrubvae_torch.train.parity`` (losses, gradients, weights to four ulps,
   MALS, QDA, MCMI; the discriminator after its inner fit to 1e-3 on each
   leaf and 1e-4 on the median leaf, see ``ADV_TOL``), step 2's losses at
   rtol 1e-2; the same step 1 with one inner discriminator step left out
   must fail the discriminator's bounds. Then a copy of the config file
   (20 epochs, validation at epoch 20 only) through ``params.read.config`` and ``train(config,
   datasets, model, info)`` at full width on the fit phase's splits: every
   loss column and ``lambda_qda_ids`` finite at every epoch, the validation
   losses finite at 20, 2 outer and 5 inner optimizer launches a step; the
   ``_an``, ``_qda``, ``mcmi`` and ``total_correlation`` columns and
   ``lambda_qda_ids`` printed at epochs 1, 5, 10 and 20. The discriminator's
   22-leaf set in one kernel call, bitwise against the plain version, its
   device time (profiler) and call time beside the bound, the plain
   version's and ``torch._fused_adamw_``'s. Then, with deterministic
   algorithms, the run's own epoch 21 against a resume from epoch 20: the
   restored state and the epoch-21 state bit for bit (model, moments,
   MALS, QDA, discriminator and MCMI states, generator, batch order).
   Prints the step time inside ``fit``, the train-epoch, validation-epoch,
   MCMI-refresh and decodability times and the peak memory.

9. bench: ``scrubvae_torch.bench.run`` at its defaults, as ``python -m
   scrubvae_torch.bench`` runs it (the flagship of the path phase, batch
   512, bf16 storage, 5 warm-up and 100 timed steps of
   ``Trainer.train_epoch``, one more step under the cost counter,
   ``scrubvae_torch.utils.step_cost``); its JSON line is printed. Requires
   a finite total, 2 optimizer launches a step, 0 < mfu <= 1,
   ``gflops_per_step`` within 0.1% of ``FLAGSHIP_GFLOPS``,
   ``bytes_per_step`` > 0 and 0 < ``bound_ms_per_step`` <= ``step_ms`` (a
   bound above the measured time is an impossible reading), and the
   counter's fused AdamW bytes equal to ``leaf_bytes`` over the flagship's
   leaf table (one bench-built flagship's parameters and moments).
10. x360: the x360 windows and the heading-free encoder view, then two
   shipped configs of that process. First ``materialize`` of every key
   (``raw_pose``, ``x6d_enc``, ``root_enc`` included) over the structured
   val split on the card against the CPU, within the CPU tests'
   tolerance, and the window assembly of a batch of 64 with and without
   the view timed. Then steps 1 and 2 of ``configs/sane/4_full.yaml`` (every
   scrubber, heading among the scrubbed features, negative MALS weights)
   on the card against the CPU at narrow channels, z 32, batch 16, f32,
   without clip, held as the full phase holds 5_full (the discriminator's
   leaves to 2e-2, its median leaf to 1e-4). Then
   ``configs/sweep/8_structural.yaml`` (x360 target, midfwd encoder view)
   and ``configs/sane/4_full.yaml``, each read from a copy of the file by
   ``params.read.config`` and run through ``factory.data_and_model`` and
   ``train(config, datasets, model, info)`` at the files' own widths
   (channels 16-32-32-64-64, z 32, batch 64, bf16 compute) on the
   structured stream at the size ``tools/run_ladder.py`` gives them (train
   24000 frames, val 8000, 4 ids, seeds 0 and 1; the pose arrays are
   served from memory in place of the pose files): one epoch, numbered 5
   (``model.start_epoch: 4`` with nothing loaded, as validation runs at
   epochs divisible by 5), validating with
   decodability at 5. Every
   loss, validation and decodability column finite, the optimizer's
   launches a step equal to its dtype variants (plus 5 inner launches for
   4_full), and each run's leaf tables (the outer one and 4_full's
   discriminator's, at their shapes and dtypes) in one kernel call each,
   bitwise against the plain version. Prints the step time inside
   ``fit``, the epoch, validation and decodability times and the peak
   memory beside the card's name.

11. models: the mlp and transformer model families and the scrubber
   branches no shipped config uses. First ``configs/ladder/1_vanilla_mlp.yaml``
   at its own widths (z 16, hidden 256-128, batch 64) on the x360 runs'
   structured splits, as those runs go (epoch 5, validation with
   decodability). Then steps 1 and 2 on the card against the CPU of the
   flagship's method map on the transformer, and of the branches' method
   map on the rcnn, at z 16, window 51, f32, without clip, dropout off
   (batch 16, and 32 for the branches, whose least-squares system needs
   more rows than its 17 columns), held to ``scrubvae_torch.train.parity``.
   Then the flagship's config with ``model: {type: transformer, z_dim: 128,
   window: 51, diag: false}`` (4 heads, ``ff_size`` 512, 4 layers, gelu;
   batch 512, bf16 storage; linear, MALS and gradient-reversal scrubbers on
   avg_speed_3d, decoding conditional on avg_speed_3d and heading) and the
   flagship rcnn with every branch (MALS at polynomial 2 on avg_speed_3d,
   direct least squares on heading with a negative weight, gradient
   reversal on the ids under ``gr_legacy_norm``, the moving-average class
   means of the ids), each through ``params.read.config`` and
   ``train(config, datasets, model, info)`` on the fit phase's splits for
   epochs 19 and 20 (validation, decodability and the full state at 20).
   Every loss column finite at every epoch, the validation losses and
   decodability finite at 20, 2 optimizer launches a step, each run's leaf
   table bitwise against the plain version. For the transformer, its dropout
   at the 0.1 rate on one flagship batch (the kept share of each residual
   and positional mask within 0.005 of 0.9, kept entries scaled by 1/0.9,
   each residual tail's kernel within 4 ulps of the plain version with its
   mask, one attention mask for the whole batch and every head, no mask drawn in
   eval mode or by the eval step), then its epoch 21 against a resume from
   epoch 20, bit for bit (the dropout masks' generator included). Prints
   each run's step time inside ``fit``, the epoch, validation and
   decodability times and the peak memory beside the card's name.

12. surface: the rest of the training config surface. First steps 1 and 2
   on the card against the CPU at z 16, window 51, f32, batch 16, without
   clip, for the low-rank sigma head (rank 8), the beta prior (the CPU's
   gamma draws injected on the card), sgd and the unfused Adam (a last
   channel of 128, so fc_sigma keeps bf16 moments; the same host-drawn
   rounding bits on both sides), held to ``scrubvae_torch.train.parity``.
   Then, at the flagship's widths (channels 64-1024, window 51, z 128,
   batch 512, bf16), each through ``params.read.config``,
   ``factory.data_and_model`` (or ``factory.build_model`` on the fit
   phase's splits) and ``train(config, datasets, model, info)`` for epochs
   19 and 20 with deterministic algorithms: (1) the parkinsons data (8
   animals, raw ids 0 to 3 and 36 to 39, a 40-row ``metadata.csv``) as
   per-key split files made by the port's ``preprocess_data`` functions on
   the card and served from memory through ``factory.read_key_h5``, with
   fluorescence among the scrubbed features: validation and decodability
   (ids and pd_label) at 20, the recoded ids, pd_label and fluorescence
   equal to the CPU loader's, the resume from 20 bit for bit; (2) the same
   recordings as raw pose files, whose columns ride as extras: equal to
   (1)'s window for window, one epoch; (3) the flagship with
   ``data.host_stream: true``: its first 3 slab batches, through
   ``prefetch_to_device``, bitwise equal to the device-resident batches,
   and its loss columns bitwise equal to a device-resident run's (no
   decodability there), with the step times and the wait on the copy;
   (4) the flagship with ``model.prior: beta``, with ``train.optimizer:
   sgd`` (clip 1) and with ``train.fused_optimizer: false``, validation at
   20 without decodability, the resume bitwise. The kernel runs 2 launches
   a step on every fused run and 0 on the sgd and unfused runs. Then
   ``scrubvae_torch.bench`` (20 timed steps) at its defaults, with
   ``--sigma-rank 256``, ``--host-stream``, ``--f32-params`` and
   ``--no-fused --f32-params``. The low-rank (132 leaves), beta-prior (130)
   and parkinsons tables each go through the kernel in one call, bitwise
   against the plain version.

13. analysis: the offline analysis at full flagship width on the fit
   phase's run folder (weights at epochs 15 and 20; run alone, ``--phases
   analysis`` first trains the fit phase's config to epoch 20 without
   decodability). The fit phase's val split tenfold (4 ids x 26,000 frames,
   51,900 windows) is built by ``factory.mouse_data`` (the pose file a
   placeholder served from memory). ``evals.latents.latents`` encodes it
   under the weights of epochs 15 and 20 (the model built from the config,
   the weights loaded); ``evals.cluster.gmm`` at its defaults (25 full
   components, float32) clusters epoch 15 into the run's cache, every
   weight above 0, held against a float64 E-step on the host with the
   fitted parameters (labels, mean log-likelihood, EM's ascent);
   ``evals.metrics.epoch_cluster_entropy`` scores epoch 20
   against that clustering, finite and within [0, log2 25];
   ``evals.cluster.dbscan`` (HDBSCAN) runs at min_samples 500 on every
   latent of epoch 20. Card against CPU: the float64 GMM on 5,120 latents
   (the same k-means++ centres, ``n_iter_`` and labels, the parameters
   within ``GMM_CARD_CPU_RTOL``) and the float32 GMM on the same latents
   (``GMM_F32_ITERS`` iterations: the same centres, labels but for
   ``GMM_F32_LABELS``, weights, means and covariances within
   ``GMM_F32_RTOL``, each device's precision factors within their
   condition bound), HDBSCAN's labels on 5 planted 128-d blobs
   of 1,024 points (each recovered) and on 5,120 latents, and its core
   distances and MST edges bitwise on 1,024; ``evals.traverse.traverse_latent``
   with 15 shifts, graded and circle, rendering off, on the epoch-20
   weights in f32 (TF32 off) within ``TRAVERSE_CARD_CPU_TOL``. Then
   ``utils.profiling``: ``trace`` writes ``build/analysis_trace/trace.json``
   with kernel events, ``device_memory_stats`` names the card,
   ``debug_nans`` raises on a NaN planted in the forward and in the
   backward pass and not once it is off; and ``scrubvae_torch.plot``
   imports without matplotlib. Prints each step's time (GMM: k-means++,
   EM per iteration; HDBSCAN: core distances, MST, tree) beside the card's
   name and power limit.

14. serve: the serving path and the reference ``.pth`` interop. The
   flagship (the path phase's model and conditionals, f32, weights from
   ``factory.init_weights`` at seed 0, as ``python -m
   scrubvae_torch.serve_bench --flagship`` builds it) is exported on the
   card (``utils.export``: encoder, mu-only encoder, decoder, from an
   example batch of 2) with the packed head's index cache emptied first, as
   in a fresh exporting process; the packed head's eager outputs (eval
   encoder, train-mode sampler, with deterministic algorithms) after the
   exports must equal the ones before them bit for bit; ``encoder_mu.pt2``
   must be smaller than ``encoder.pt2`` by at least 0.9 times
   ``fc_sigma``'s bytes; each artifact, loaded with ``load_exported``, is
   held against the eager model at batches 1, 8, 64 and 512 within
   ``SERVE_TOL``; the encoder exported on the CPU from the same
   weights, loaded onto the card, likewise at batch 64; then the three
   artifacts are timed (``serve_bench.bench``, the lines of
   ``--flagship``, each point over ``serve_bench.SECONDS`` of pipelined
   windows with their spread), and at each batch size each call's device time
   (torch.profiler, the median of ``SERVE_DEVICE_SESSIONS`` sessions with
   their spread), the device's idle share of the pipelined latency, the
   eager model's pipelined latency and the mu-only encoder's saving on the
   device. Then a run the port trains and
   saves (the flagship, bf16, 3 steps through ``Trainer`` at batch 512, 2
   optimizer launches a step; weights at epoch 5; the pose arrays served
   from memory through ``factory.read_pose_h5``) goes through ``python -m
   scrubvae_torch.export_model``, its artifacts held against the trained
   model at batch 64 within ``SERVE_TOL``, ``serve_bench --run``
   (its lines printed) and ``export_torch``; the ``.pth`` imported into a
   fresh model (``import_torch_weights``) must map every key, fill every
   leaf and give the trained weights bit for bit (``num_batches_tracked``
   0). Exporting and serving launch no optimizer kernel: serving trains
   nothing, and the path has no kernel of its own.

15. mesh: ``train.mesh`` with the ranks sharing the one card
   (``torch.multiprocessing``: four processes started once serve every
   mesh, each mesh a gloo process group over a file store in a temporary
   directory; deterministic algorithms), at the flagship's full width
   (batch 512). The single-rank step in f32 (compute, storage and moments)
   from the seed's weights, fixed rows and noise is the reference. Then
   ``{data: 2}``, ``{data: 1, model: 2}`` and ``{data: 2, model: 2}`` (4
   ranks), each rank building the trainer under that ``train.mesh``: the
   same f32 step, which rank 0 holds to the reference with the step-1
   bounds of ``scrubvae_torch.train.parity``; then the bf16 flagship for 3
   warm-up and 5 timed steps (1 and 3 on 4 ranks): 2 kernel launches a
   step on every rank, a finite total, and every replicated parameter,
   moment, BatchNorm buffer and MALS state bit for bit equal across the
   ranks (a split leaf and its moments across its replicas). With a model
   axis each rank's slice of ``fc_sigma`` goes through the kernel as the
   trainer's table launches it (its leaf word, its first element) on the
   live slice, moments and this step's gradient: bitwise equal to the
   plain version at that offset and to the same rows of one launch over
   the whole leaf, then timed beside its bound, the plain version's and
   ``torch._fused_adamw_``'s. The 4-rank mesh saves its f32 state (rank 0
   writes), which holds the ranks' own bit for bit and restores into the
   same mesh and into one device bit for bit. Prints each mesh's step time
   per rank beside the card's name: ranks sharing one card over gloo, not a
   scaling number.

16. graph: ``train.scan_epoch``'s CUDA graphs
   (``scrubvae_torch.train.graph``), with deterministic algorithms. The
   flagship at full width (the bench's config, batch 512, bf16) trains an
   epoch of 20 steps, a validation epoch (5652 windows: 11 full batches and
   a tail), an epoch of 4 steps and a second validation epoch (which
   replays the validation graph kept from the first after reseeding its
   generator) as graphs and eagerly (``scan_epoch: false``, the same
   in-place step from the host): the epoch metrics, the validation mu, the
   parameters, moments, BatchNorm statistics, MALS state, step counts and
   generators bit for bit alike, and the same kernel launches (2 a step; a
   graph's counted from its replays). ``configs/ladder/5_full.yaml`` at its
   full width likewise over an epoch, the validation epoch (whose MCMI
   refresh moves the estimator, so the train step is captured again) and
   another epoch (2 outer and 5 inner launches a step); then sgd, the
   unfused Adam, the beta prior, the transformer (dropout) at the bench's
   small widths and ``configs/sane/4_full.yaml`` (x360) at its own, each
   over two epochs, each followed by a validation epoch. Then the kernel
   captured in a graph with its step word over a table of the flagship's
   leaves (random values) and replayed 3 times, bitwise equal to the plain
   version at steps 1 to 3, and its replayed pass timed beside the eager
   call. Then ``python -m scrubvae_torch.profile_step``'s line of the
   flagship eagerly and in a graph (20 steps) and the bench's step time and
   rate both ways (20 steps), with each epoch's seconds and the peak memory
   of both runs above (over what was allocated when each run began), beside
   the card's name.

17. spans: the train step's spans (``scrubvae_torch.utils.profiling``,
   the stamp kernel ``csrc/step_spans.cu``), with the stamp launches
   counted from 0. Three steps' stamps (the gap's, then the step's order)
   into a spans buffer on the card and one on the CPU: the same counts on
   both, and on each the totals summing to the last stamp's time less the
   first's, to the nanosecond; a ``torch.cuda._sleep`` of about 2 ms
   between two stamps against CUDA events around it, within 20 us; the
   stamp's device time (profiler, 200 stamps). Then the flagship at full
   width (the bench's config, batch 512, bf16) in graph epochs of 20
   steps: an untraced epoch of replays launches no stamp and makes one
   host sync (``count_syncs``), its readback (``Trainer.host_syncs``);
   tracing on captures again, and each traced epoch launches 10 stamps a
   step; over a traced epoch of replays every slot is charged as often as
   the step's order says, and the slots sum to between 97% and 100% of
   the epoch's time between CUDA events; tracing off captures again and
   launches no stamp. Prints the slots' ms a step.

18. solves: the scrubbers' SPD solves (``scrubvae_torch.ops.smallsolve``,
   one Cholesky factor, no row swaps) under ``graph.capturable_linalg``.
   First full5's QDA likelihoods (4 classes of 128x128 covariances moved
   from the identity by ``qda_update``, batch 512; ``qda_loss`` and its
   gradient in the latent) and MALS's solve (``mals_forward``, both systems
   in one call) captured in a CUDA graph: no host sync in the warm-up, the
   capture and a replay (``count_syncs``), and the replay bitwise equal to
   the eager call. Then the device time (profiler) of the likelihoods'
   chain, forward and forward with backward, beside the pivoted LU route
   of ``torch.linalg.solve`` and ``slogdet`` on the same inputs, the
   yardstick that the port does not call; ``cholesky_solve`` beside two
   triangular solves, and MALS's batched call beside two calls. Then the
   ``full5.b512`` cell as the benchmark sets it up (``benchmark.run``):
   the kernels of one replayed step (torch.profiler) hold no pivoted LU
   (no ``laswp``, no ``getrf`` but cuSOLVER's unpivoted ``getrf_wo_pivot``,
   which its Cholesky factor runs: the kernels of each factor's shape are
   listed), and over its warm epoch and window ``spd_not_pd``
   stays 0 with 19 factorizations a step (16 QDA, 2 MALS, 1 projection).

19. nested: the transformer's nested spans (``profiling.NESTED``) in the
   ``transformer.b512`` cell as the benchmark sets it up
   (``benchmark.run``), in graph epochs of 20 steps, with the launches
   counted from 0: an untraced epoch of replays launches no stamp and no
   nested span; tracing on captures again, and each
   traced epoch launches 40 nested-span kernels a step (a pair for each of
   the 12 attention and 8 feed-forward blocks) beside the 10 stamps, and
   charges each attention and feed-forward block once a step, the two
   together under the encoder's and decoder's slots; tracing off launches
   neither again. In one traced replay under the profiler: 10
   ``span_stamp`` and 40 ``nested_span`` kernels. One eager training
   forward of the cell's VAE at batch 512 draws 73,552,404 dropout values
   (``torch.rand``; 22 x 512 x 51 x 128 + 8 x 51 x 51 + 4 x 51), and none
   in eval mode. Then ``flagship.b512`` and ``full5.b512`` set up alike: a
   traced replay holds 10 ``span_stamp`` kernels and no ``nested_span``
   kernel.
20. norm: the transformer's post-norm tail (``ops/residual_norm.py``,
   ``csrc/residual_norm.cu``) at the cell's shape, (512, 51, 128) f32, with
   a keep mask at rate 0.1 from a generator and without one: the kernels'
   output and its three gradients (dx, dy and dweight with dbias) beside
   the plain version's on the card, both against the plain version in
   float64; the kernels' error may not exceed twice the plain version's
   (plus 2^-22 of the largest value), and the output's largest gap to the
   plain f32 version is given in f32 ulps at its scale. A second run
   repeats every output bit for bit (dweight and dbias sum in a fixed
   order). The masked check runs again at the widths 130, 1000, 1001 and
   3632 (one-float chunks; 16-byte chunks and one-float chunks with the
   backward past 48 KB of shared memory; the most a row). Then
   ``transformer.b512`` as the benchmark sets it up: a graph epoch of
   replays launches 20 forward and 40 backward kernels a step (20 tails;
   two backward kernels a tail), an eval forward 20 and 0; its encoder
   exported on the card (``utils.export``) launches none while it is
   traced or its artifact runs, and the artifact gives the eager
   encoder's outputs (8 tails by the kernels) within the serve phase's
   tolerance. ``flagship.b512`` launches none. Last, device times (torch.profiler,
   over input sets that together exceed the 50 MB L2): forward and
   backward kernels beside their bound at 3.35 TB/s, the plain version's
   ops and ``F.layer_norm`` of the pre-added sum (``library_ms``, a
   yardstick the port never calls).

Each phase logs its wall seconds ("phase NAME: S s"). Prints one JSON line
describing the kernels (``fused_adamw`` where phases kernel and path ran;
``residual_norm`` from phase norm, its figures null where it did not run),
the card's name and power limit again, then, as its
last line, the device record. Needs one CUDA GPU and
``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM data sheet, f32 outside the tensor cores
ADAMW_FLOPS_PER_ELEM = 20
ROOT = pathlib.Path(__file__).resolve().parent
PHASES = (
    "kernel", "parity", "path", "fit", "full", "bench", "x360", "models", "surface", "analysis", "serve", "mesh", "graph",
    "spans", "solves", "nested", "norm",
)
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same dtype, shape and bits (tells -0.0 from 0.0 and compares NaN
    payloads; integer tensors compare by value)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    as_int = {8: torch.int64, 4: torch.int32, 2: torch.int16}[a.element_size()]
    return torch.equal(a.view(as_int), b.view(as_int))


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` on the card, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# profiling sessions device_ms runs before it fails for want of device time
PROFILER_SESSIONS = 3


def device_ms(fn, iters: int = 50) -> float:
    """Device time of one call of ``fn``: every kernel it launches, summed
    over ``iters`` calls by torch.profiler, over ``iters``. A profiling
    session that delivers no kernel record at all (seen once on the card,
    on the discriminator's 22-leaf pass) is run again, up to
    ``PROFILER_SESSIONS`` in all; none with device time fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        if busy > 0:
            return busy / 1e3 / iters
        log("device_ms: a profiling session saw no device time; running it again")
    raise AssertionError(f"device_ms: the profiler saw no device time in {PROFILER_SESSIONS} sessions")


# ---------------------------------------------------------------------------
# phase 3: the fused AdamW kernel
# ---------------------------------------------------------------------------

KERNEL_SHAPES = (
    ("encoder.fc_sigma.0.weight", (4096, 8256)),
    ("encoder.conv_in.weight", (64, 111, 7)),
)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _leaf_inputs(shape, w_dt, m_dt, gen):
    dev = torch.device("cuda")

    def randn(scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    w = randn(0.05).to(w_dt)
    g = randn(1e-2).to(w_dt)
    mu = randn(1e-3).to(m_dt)
    nu = (randn(1e-4) ** 2).to(m_dt)
    return w, g, mu, nu


def _bound(bytes_moved: int, n: int) -> tuple:
    """The least time (ms) the card could take, and what sets it."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S
    by_ops = ADAMW_FLOPS_PER_ELEM * n / F32_FLOP_PER_S
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops else "operations")


def _assert_bits(name: str, got, want) -> float:
    """Raise unless ``got`` and ``want`` (w, m, n) are bitwise equal;
    returns the max |difference| (0)."""
    err = 0.0
    for label, a, b in zip("wmn", got, want):
        if not bits_equal(a, b):
            diff = (a.float() - b.float()).abs().max().item()
            raise AssertionError(f"kernel != plain version for {name} on {label}: max |diff| {diff}")
        err = max(err, (a.float() - b.float()).abs().max().item())
    return err


def kernel_phase(flagship) -> dict:
    """Each dtype variant at two shapes: bitwise against the plain version
    with injected noise and on the Philox path, stochastic rounding
    unbiased, and (at fc_sigma) the kernel's time beside the plain
    version's, the library call's and the bound; then the whole flagship
    leaf set in one multi-tensor call."""
    from scrubvae_torch.ops import fused_adamw as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    scal, hyper, t = _outer_hyper()
    lr, b1c, b2c, gscale = scal.unbind(0)
    timings = {}
    max_err = 0.0
    for name, shape in KERNEL_SHAPES:
        n = math.prod(shape)
        for wk, mk in (("f32", "f32"), ("f32", "bf16"), ("bf16", "f32"), ("bf16", "bf16")):
            case = f"{name} w={wk} m={mk}"
            w_dt, m_dt = DTYPES[wk], DTYPES[mk]
            w, g, mu, nu = _leaf_inputs(shape, w_dt, m_dt, gen)
            noise = torch.randint(
                0, 1 << 16, (3, n), generator=gen, device="cuda", dtype=torch.int32
            )
            # bitwise against the plain version on the same injected noise
            ref = fa.fused_adamw_leaf_reference(
                w, g, mu, nu, lr=lr, b1c=b1c, b2c=b2c, gscale=gscale, noise=noise, **hyper
            )
            kw, km, kn = w.clone(), mu.clone(), nu.clone()
            fa.fused_adamw_multi(fa.LeafTable([kw], [km], [kn], noise=[noise]), [g], scal, **hyper)
            torch.cuda.synchronize()
            max_err = max(max_err, _assert_bits(case + " (injected noise)", (kw, km, kn), ref))
            # Philox path: bitwise against the plain version on philox_noise
            pw, pm, pn = w.clone(), mu.clone(), nu.clone()
            fa.fused_adamw_multi(fa.LeafTable([pw], [pm], [pn], leaf_ids=[7]), [g], scal, seed=1234, step=t, **hyper)
            ref = fa.fused_adamw_leaf_reference(
                w, g, mu, nu, lr=lr, b1c=b1c, b2c=b2c, gscale=gscale,
                noise=fa.philox_noise(n, 1234, 7, t, device="cuda"), **hyper,
            )
            torch.cuda.synchronize()
            max_err = max(max_err, _assert_bits(case + " (Philox)", (pw, pm, pn), ref))
            # and unbiased (mean rounding error within 4 sigma)
            exact = fa.fused_adamw_leaf_reference(
                w.float(), g.float(), mu.float(), nu.float(),
                lr=lr, b1c=b1c, b2c=b2c, gscale=gscale, **hyper,
            )
            sr = []
            for label, got, want in zip("wmn", (pw, pm, pn), exact):
                if got.dtype != torch.bfloat16:
                    if not bits_equal(got, want):
                        raise AssertionError(f"f32 store differs from exact for {case} on {label}")
                    continue
                err = (got.double() - want.double()).flatten()
                mean, sd = err.mean().item(), err.std().item()
                z = mean / (sd / math.sqrt(err.numel())) if sd > 0 else 0.0
                if abs(z) > 4.0:
                    raise AssertionError(
                        f"stochastic rounding biased for {case} on {label}: "
                        f"mean {mean:.3e}, {z:.2f} sigma"
                    )
                sr.append(f"{label}:{z:+.2f}sigma")
            rec = {"bitwise_injected": True, "bitwise_philox": True,
                   "sr_mean_err": " ".join(sr) or "no bf16 store"}
            if name == KERNEL_SHAPES[0][0]:
                rec["bytes"] = fa.leaf_bytes([shape], w.element_size(), mu.element_size())
                rec["bound_ms"], rec["bound_by"] = _bound(rec["bytes"], n)
                # tables built once, as the optimizer builds them
                table = fa.LeafTable([kw], [km], [kn], leaf_ids=[0])
                rec["kernel_ms"] = cuda_ms(
                    lambda: fa.fused_adamw_multi(table, [g], scal, seed=1, step=t, **hyper)
                )
                if wk == "bf16" and mk == "bf16":
                    # reads 12 B an element more than the Philox path
                    inj = fa.LeafTable([kw], [km], [kn], noise=[noise])
                    rec["inject_ms"] = cuda_ms(
                        lambda: fa.fused_adamw_multi(inj, [g], scal, **hyper)
                    )
                    rec["inject_bound_ms"] = (rec["bytes"] + 12 * n) / HBM_BYTES_PER_S * 1e3
                rec["plain_ms"] = cuda_ms(
                    lambda: fa.fused_adamw_leaf_reference(
                        kw, g, km, kn, lr=lr, b1c=b1c, b2c=b2c, gscale=gscale, noise=noise, **hyper
                    )
                )
                if wk == "f32" and mk == "f32":
                    steps = [torch.tensor(float(t), device="cuda")]
                    rec["library_ms"] = cuda_ms(
                        lambda: torch._fused_adamw_(
                            [kw], [g], [km], [kn], [], steps,
                            lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=0.01,
                            eps=1e-8, amsgrad=False, maximize=False,
                        )
                    )
                timings[f"w {wk}, m {mk}"] = rec
            log(f"kernel fused_adamw {name} {tuple(shape)} w={wk} m={mk}: " + json.dumps(rec))
            del w, g, mu, nu, noise, ref, kw, km, kn, exact, pw, pm, pn
            torch.cuda.empty_cache()
    leaf_set = leaf_set_check(flagship, scal, hyper, t)
    max_err = max(max_err, leaf_set.pop("max_abs_err"))
    return {"timings": timings, "max_abs_err": max_err, "leaf_set": leaf_set}


def _outer_hyper():
    """(scalars, hyperparameters, step) of the kernel checks' AdamW step."""
    t = 3
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    scal = torch.tensor(
        [1e-3, 1.0 - 0.9**t, 1.0 - 0.999**t, 0.7], dtype=torch.float32, device="cuda"
    )
    return scal, hyper, t


# what a training run reports of its leaf set's check
LEAF_SET_KEYS = (
    "leaves", "elements", "launches_per_call", "pass_ms", "pass_device_ms", "pass_plain_ms", "pass_bound_ms",
    "pass_library_ms",
)


def leaf_set_check(trainer, scal, hyper, t, label: str = "flagship") -> dict:
    """A trainer's whole leaf set (its parameters' shapes and dtypes, its
    moments' dtypes, random values) in one multi-tensor call on the Philox
    path, bitwise against the plain version leaf by leaf; then the pass's
    time (CUDA events around 20 calls) and device time (profiler) beside
    its bound, the plain version's time and ``torch._fused_adamw_`` over
    f32 copies of every leaf."""
    from scrubvae_torch.ops import fused_adamw as fa

    params = list(trainer.model.parameters())
    moments = trainer.state.opt_state.mu
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(like, scale, dtype):
        return (torch.randn(like.shape, generator=gen, device="cuda") * scale).to(dtype)

    ws = [randn(p, 0.05, p.dtype) for p in params]
    gs = [randn(p, 1e-2, p.dtype) for p in params]
    mus = [randn(m, 1e-3, m.dtype) for m in moments]
    nus = [(randn(m, 1e-2, torch.float32) ** 2).to(m.dtype) for m in moments]
    table = fa.LeafTable([w.clone() for w in ws], [m.clone() for m in mus], [v.clone() for v in nus])
    seed = 17
    fa.fused_adamw_multi(table, gs, scal, seed=seed, step=t, **hyper)
    lr, b1c, b2c, gscale = scal.unbind(0)
    refs = fa.fused_adamw_multi_reference(
        ws, gs, mus, nus, lr=lr, b1c=b1c, b2c=b2c, gscale=gscale, seed=seed, step=t, **hyper
    )
    torch.cuda.synchronize()
    err = 0.0
    for i, ref in enumerate(refs):
        got = (table.w[i], table.mu[i], table.nu[i])
        err = max(err, _assert_bits(f"leaf {i} {tuple(ws[i].shape)} of the {label} set", got, ref))
    del refs
    n = sum(table.numel)
    bytes_moved = sum(
        fa.leaf_bytes([w.shape], w.element_size(), m.element_size()) for w, m in zip(ws, mus)
    )
    rec = {
        "leaves": len(ws), "elements": n, "launches_per_call": len(table.batches),
        "bitwise_philox": True, "max_abs_err": err, "bytes": bytes_moved,
        "pass_ms": cuda_ms(lambda: fa.fused_adamw_multi(table, gs, scal, seed=seed, step=t, **hyper)),
        "pass_device_ms": device_ms(lambda: fa.fused_adamw_multi(table, gs, scal, seed=seed, step=t, **hyper)),
        "pass_plain_ms": cuda_ms(
            lambda: fa.fused_adamw_multi_reference(
                ws, gs, mus, nus, lr=lr, b1c=b1c, b2c=b2c, gscale=gscale, seed=seed, step=t, **hyper
            )
        ),
    }
    rec["pass_bound_ms"], rec["bound_by"] = _bound(bytes_moved, n)
    f32 = [[x.float() for x in xs] for xs in (ws, gs, mus, nus)]
    steps = [torch.tensor(float(t), device="cuda") for _ in ws]
    rec["pass_library_ms"] = cuda_ms(
        lambda: torch._fused_adamw_(
            *f32, [], steps, lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=0.01,
            eps=1e-8, amsgrad=False, maximize=False,
        )
    )
    log(f"kernel fused_adamw {label} leaf set: " + json.dumps(rec))
    del f32, table, ws, gs, mus, nus
    torch.cuda.empty_cache()
    return {**rec, "max_abs_err": err}


# ---------------------------------------------------------------------------
# phase 4: one small step on the card against the same step on the CPU
# ---------------------------------------------------------------------------


def _one_step(trainer, device: str, rows: np.ndarray, eps: np.ndarray) -> dict:
    from scrubvae_torch.train.parity import MALS_KEYS

    names = [n for n, _ in trainer.model.named_parameters()]
    trainer.state, metrics = trainer.train_step(
        trainer.state, torch.as_tensor(rows, device=device), trainer.loss_scale_for_epoch(1),
        eps=torch.from_numpy(eps).to(device),
    )
    mals = trainer.state.scrub_state["moving_avg_lsq"]["avg_speed_3d"]
    b1 = trainer.tx.b1
    return {
        "losses": {k: float(v) for k, v in metrics.items()},
        # step 1: m = (1 - b1) g
        "grads": {n: m.cpu() / (1.0 - b1) for n, m in zip(names, trainer.state.opt_state.mu)},
        "w1": {n: p.detach().cpu() for n, p in trainer.model.named_parameters()},
        "mals": {k: getattr(mals, k).cpu() for k in MALS_KEYS},
    }


def _same_bits(a: dict, b: dict) -> bool:
    return a["losses"] == b["losses"] and all(
        bits_equal(a[part][k], b[part][k]) for part in ("grads", "w1", "mals") for k in a[part]
    )


def parity_phase() -> dict:
    """One ``--small`` step on the card against the same step on the CPU
    (same weights, noise and window rows), held to the step-1 bounds of
    ``scrubvae_torch.train.parity``. The card takes the step twice with
    deterministic algorithms (cuDNN, cuBLAS, index_add), and the two must be
    bitwise equal, so the verdict does not change from one run to the next."""
    from scrubvae_torch.train import parity

    from scrubvae_torch import bench

    cpu_trainer, ds = bench.build(16, 51, 16, bench.SMALL_CH, "cpu", precision="fp32", bf16_params=False)
    rows = np.random.default_rng(0).integers(0, len(ds), 16)
    eps = np.random.default_rng(1).standard_normal((16, 16)).astype(np.float32)
    cpu = _one_step(cpu_trainer, "cpu", rows, eps)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        gpu, again = [
            _one_step(
                bench.build(16, 51, 16, bench.SMALL_CH, DEVICE, precision="fp32", bf16_params=False)[0],
                DEVICE, rows, eps,
            )
            for _ in range(2)
        ]
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    if not _same_bits(gpu, again):
        raise AssertionError("parity: two deterministic steps on the card differ")
    rec = {
        "max_loss_rel": parity.check_losses(cpu["losses"], gpu["losses"], 1e-4),
        **parity.check_grads(cpu["grads"], gpu["grads"]),
        **parity.check_weights(cpu["w1"], gpu["w1"], cpu["grads"]),
        "max_mals_rel": parity.check_mals(cpu["mals"], gpu["mals"], 1e-4),
        "repeat_bitwise_equal": True,
    }
    log("parity small step, card vs CPU: " + json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# phase 5: the flagship train step at full width
# ---------------------------------------------------------------------------


FLAGSHIP_LEAVES = 130
FLAGSHIP_PARAMS = 53_308_812


def path_phase(trainer, ds, warmup: int = 3, steps: int = 20):
    """The flagship step through ``Trainer.train_step``: losses finite, one
    kernel launch per dtype variant a step over a table of every leaf; then
    the optimizer pass alone beside the bytes it must move."""
    from scrubvae_torch.ops import fused_adamw as fa

    batch = trainer.batch_size
    params = list(trainer.model.parameters())
    opt = trainer.state.opt_state
    table = opt.table
    variants = {}
    for p, m in zip(params, opt.mu):
        key = f"w {'bf16' if p.dtype == torch.bfloat16 else 'f32'}, m {'bf16' if m.dtype == torch.bfloat16 else 'f32'}"
        variants[key] = variants.get(key, 0) + 1
    n_params = sum(p.numel() for p in params)
    if (len(params), n_params) != (FLAGSHIP_LEAVES, FLAGSHIP_PARAMS) or (
        len(table.w), sum(table.numel)
    ) != (len(params), n_params):
        raise AssertionError(
            f"path: {len(params)} leaves of {n_params} elements, table {len(table.w)} of "
            f"{sum(table.numel)}; expected {FLAGSHIP_LEAVES} of {FLAGSHIP_PARAMS}"
        )
    rows = torch.as_tensor(
        np.random.default_rng(0).integers(0, len(ds), (warmup + steps, batch)), device=DEVICE
    )
    loss_scale = trainer.loss_scale_for_epoch(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics = []
    _reset_launches()
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        trainer.state, m = trainer.train_step(trainer.state, rows[i], loss_scale)
        metrics.append(m)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    launches = _launches()

    losses = {k: torch.stack([m[k] for m in metrics]).float().cpu() for k in metrics[0]}
    bad = [k for k, v in losses.items() if not bool(torch.isfinite(v).all())]
    if bad:
        raise AssertionError(f"path: non-finite losses {bad}")
    if len(table.batches) != len(variants) or launches != len(variants) * (warmup + steps):
        raise AssertionError(
            f"path: {launches} kernel launches in {warmup + steps} steps; expected one per "
            f"dtype variant ({len(variants)}) a step"
        )

    # the optimizer pass alone: one update_and_apply over every leaf, on
    # gradients of the leaves' shapes and dtypes (its cost does not depend
    # on their values), beside the bytes it must move
    grads = [torch.randn_like(p) * 1e-3 for p in params]
    opt_ms = cuda_ms(lambda: trainer.tx.update_and_apply(grads, trainer.state.opt_state, params), iters=10)
    opt_bytes = sum(
        fa.leaf_bytes([p.shape], p.element_size(), m.element_size()) for p, m in zip(params, opt.mu)
    )
    rec = {
        "batch": batch, "channels": trainer.config["model"]["channel"], "window": 51, "z_dim": 128,
        "precision": "bf16", "param_dtype": "bf16", "warmup_steps": warmup, "timed_steps": steps,
        "step_ms": step_s * 1e3, "samples_per_s": batch / step_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "leaves": len(params), "params": n_params,
        "leaf_variants": variants, "kernel_launches": launches,
        "launches_per_step": launches / (warmup + steps),
        "first_total": float(losses["total"][0]), "last_total": float(losses["total"][-1]),
        "optimizer_pass_ms": opt_ms, "optimizer_pass_bytes": opt_bytes,
        "optimizer_pass_bound_ms": opt_bytes / HBM_BYTES_PER_S * 1e3,
    }
    log("path flagship train step: " + json.dumps(rec))
    return rec, rows, loss_scale


def profile_phase(trainer, rows, loss_scale, steps: int = 5) -> None:
    """Device time by kernel over a few flagship steps (torch.profiler);
    the full table is written to build/profile_path.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            trainer.state, _ = trainer.train_step(trainer.state, rows[i], loss_scale)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: the aten ops above them carry the same device time
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    events.sort(key=lambda e: -e.self_device_time_total)
    out = ROOT / "build" / "profile_path.txt"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=60)
    )
    top = [
        {"name": e.key[:90], "ms_per_step": e.self_device_time_total / 1e3 / steps,
         "calls_per_step": e.count / steps}
        for e in events[:15]
    ]
    log("profile: " + json.dumps({
        "steps": steps, "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps, "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_launches_per_step": sum(e.count for e in events) / steps,
        "top_kernels": top,
    }))


PROFILE_CONFIGS = ("flagship", "ladder/5_full", "sane/4_full", "transformer")


def profile_configs(steps: int = 20) -> dict:
    """``python -m scrubvae_torch.profile_step``'s line, eagerly
    (``--per-step``) and in a graph, for the flagship, ``configs/ladder/5_full.yaml``
    and ``configs/sane/4_full.yaml`` at their own widths and the flagship's
    config with the transformer (``TRANSFORMER``), each beside the others
    in this one call."""
    import yaml

    from scrubvae_torch import bench, profile_step

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_profile_"))
    out = {}
    try:
        for name in PROFILE_CONFIGS:
            args = ["--steps", str(steps)]
            if name == "transformer":
                cfg = bench.bench_config(512, 51, 128, bench.FULL_CH, True)
                cfg["model"].update(TRANSFORMER)
                path = tmp / "transformer.yaml"
                path.write_text(yaml.safe_dump(cfg))
                args += ["--config", str(path)]
            elif name != "flagship":
                args += ["--config", str(ROOT / "configs" / f"{name}.yaml")]
            for label, flags in (("eager", ["--per-step"]), ("graph", [])):
                rec = profile_step.run(profile_step.parse_args(args + flags))
                out[f"{name} {label}"] = rec
                log(f"profile_step {name} {label}: " + json.dumps(rec))
                log((ROOT / rec["classes_table"]).read_text().rstrip())
                if not (rec["bytes_per_step"] > 0 and 0 < rec["bound_ms_per_step"] <= rec["device_busy_ms_per_step"]):
                    raise AssertionError(
                        f"profile {name} {label}: bytes {rec['bytes_per_step']}, bound "
                        f"{rec['bound_ms_per_step']} ms above the device's busy {rec['device_busy_ms_per_step']} ms"
                    )
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 7: the training entry point at full width
# ---------------------------------------------------------------------------

FIT_EPOCHS = 20
# epochs 11 to 20 (model.start_epoch 10, nothing loaded): validation and
# weights at 15 and 20; few epochs keep the whole script within its time
FIT_START = 10
DECOD_COLUMNS = tuple(
    f"{m}_{s}"
    for m in (
        "r2_avg_speed_3d_lin", "r2_avg_speed_3d_mlp", "r2_heading_lin", "r2_heading_mlp",
        "acc_ids_log", "acc_ids_qda",
    )
    for s in ("mean", "std")
)
# card against CPU on the same mu: the bands of the CPU tests
# (tests/test_torch_port_decodability.py)
LIN_R2_CARD_CPU = 1e-9
MLP_R2_CARD_CPU = 1e-3


def _fit_splits():
    """Synthetic train (4 ids x 1200 frames) and val (4 ids x 2600 frames)
    splits, on the card."""
    from scrubvae_torch import bench
    from scrubvae_torch.data.dataset import StreamDataset
    from scrubvae_torch.data.pipeline import build_frame_store
    from scrubvae_torch.data.skeleton import load_skeleton
    from scrubvae_torch.data.synthetic import synthetic_pose_stream

    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    out = {}
    for label, seed, per_id, n_ids in (("train", 0, 1200, 4), ("val", 1, 2600, 4)):
        pose, ids = synthetic_pose_stream(skel, n_frames=per_id * n_ids, n_ids=n_ids, seed=seed)
        store = build_frame_store(pose, ids, skel, window=51, stride=2, device=DEVICE)
        mid = store.ids[store.starts + 51 // 2].cpu().numpy()
        out[label] = StreamDataset(
            store, skel, bench.KEYS, "midfwd", arena_size=bench.ARENA, discrete_classes={"ids": np.unique(mid)},
            device=DEVICE, label=label,
        )
    return out


def _write_config(run: pathlib.Path, cfg: dict) -> dict:
    """``cfg`` to ``run/model_config.yaml``, read back by the port's config
    reader."""
    import yaml

    from scrubvae_torch.params import read

    run.mkdir(parents=True)
    (run / "model_config.yaml").write_text(yaml.safe_dump(dict(cfg, out_path="current")))
    return read.config(run / "model_config.yaml")


def _fit_config(run: pathlib.Path, model: dict = None, **train: dict) -> dict:
    """Write the flagship's config for ``train``, without ``minimal_test``
    and with ``model`` and ``train`` entries overridden, to
    ``run/model_config.yaml`` and read it back through the port's config
    reader."""
    from scrubvae_torch import bench

    cfg = bench.bench_config(512, 51, 128, bench.FULL_CH, True)
    del cfg["train"]["minimal_test"]
    cfg["train"].update({"num_epochs": FIT_EPOCHS, "eval_start_epoch": 0, **train})
    cfg["model"].update(model or {})
    return _write_config(run, cfg)


def _tensors_of(obj) -> list:
    """Copies of the tensor fields of a state dataclass, in field order,
    with a generator's state and an int field as tensors."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out.append(v.detach().clone())
        elif isinstance(v, list) and v and isinstance(v[0], torch.Tensor):
            out += [t.detach().clone() for t in v]
        elif isinstance(v, torch.Generator):
            out.append(v.get_state().clone())
        elif isinstance(v, int) and not isinstance(v, bool):
            out.append(torch.tensor(v))
    return out


def _trainer_state(trainer) -> dict:
    """What a resume restores, whatever the optimizer and scrubbers:
    parameters and buffers, the optimizer's state, every streaming
    scrubber state, each discriminator's parameters and optimizer state,
    the MCMI state, the step count, the generator and the batch order."""
    st = trainer.state
    return {
        "params": [p.detach().clone() for p in trainer.model.parameters()],
        "buffers": [b.clone() for b in trainer.model.buffers()],
        "opt": _tensors_of(st.opt_state),
        "scrub": [t for m in sorted(st.scrub_state) for k in sorted(st.scrub_state[m])
                  for t in _tensors_of(st.scrub_state[m][k])],
        "adv": [t for k in sorted(st.adv_states)
                for t in [p.detach().clone() for p in st.adv_states[k].net.parameters()]
                + _tensors_of(st.adv_states[k].opt_state)],
        "mi": [] if st.mi_state is None else _tensors_of(st.mi_state),
        "steps": [torch.tensor(st.step)],
        "generator": [st.generator.get_state().clone()],
        "np_rng": repr(trainer.np_rng.bit_generator.state),
    }


def _same_state(a: dict, b: dict) -> list:
    """Names of the parts of two ``_trainer_state`` records that differ."""
    bad = [
        part for part in ("params", "buffers", "opt", "scrub", "adv", "mi", "steps", "generator")
        if len(a[part]) != len(b[part])
        or not all(
            bits_equal(x, y) if x.is_floating_point() else torch.equal(x, y) for x, y in zip(a[part], b[part])
        )
    ]
    if a["np_rng"] != b["np_rng"]:
        bad.append("np_rng")
    return bad


class _Timer:
    """Wraps functions of a module or class so each call is timed on the
    host clock between two synchronizes, and its arguments kept in
    ``last``; ``undo`` puts them back."""

    def __init__(self):
        self.times: dict = {}
        self.last: dict = {}
        self._saved = []

    def wrap(self, owner, name: str, label: str) -> None:
        fn = getattr(owner, name)
        self._saved.append((owner, name, fn))

        def timed(*a, **k):
            self.last[label] = a
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.times.setdefault(label, []).append(time.perf_counter() - t0)
            return out

        setattr(owner, name, timed)

    def undo(self) -> None:
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved = []

    def mean_ms(self, label: str) -> float:
        return float(np.mean(self.times[label])) * 1e3

    def total_ms(self, label: str) -> float:
        return float(np.sum(self.times[label])) * 1e3


def decodability_card_vs_cpu(z: np.ndarray, val_ds, window: int) -> dict:
    """The estimators of ``Trainer.decodability_metrics`` on the card and on
    the CPU, on the same validation mu and labels and the same host-drawn
    folds: each rand_cv's 5 folds (linear R^2 within ``LIN_R2_CARD_CPU``,
    MLP R^2 within ``MLP_R2_CARD_CPU``, the MLP starting from the same
    CPU-drawn init), and per classification fold the QDA and LDA
    predictions (identical) and the logistic ones (at most one sample
    apart)."""
    from scrubvae_torch.evals import metrics as em
    from scrubvae_torch.evals import probes

    full = val_ds.batch(torch.arange(len(val_ds), device=DEVICE))
    labels = {k: full[k].cpu() for k in ("avg_speed_3d", "heading", "ids")}
    devices = (DEVICE, "cpu")
    rec = {"lin_r2_max_diff": 0.0, "mlp_r2_max_diff": 0.0}
    for key in ("avg_speed_3d", "heading"):
        for name, fn, band in (
            ("lin", em.linear_rand_cv, LIN_R2_CARD_CPU), ("mlp", em.mlp_rand_cv, MLP_R2_CARD_CPU),
        ):
            card, cpu = (np.asarray(fn(z, labels[key], window, 5, device=d)) for d in devices)
            if card.shape != cpu.shape or len(card) != 5:
                raise AssertionError(f"fit: {name} folds of {key}: card {card}, CPU {cpu}")
            diff = float(np.abs(card - cpu).max())
            rec[f"{name}_r2_max_diff"] = max(rec[f"{name}_r2_max_diff"], diff)
            if not diff <= band:
                raise AssertionError(f"fit: {name} R^2 of {key}, card {card} against CPU {cpu}")
    cw = em.decodability_class_window("synthetic", window)
    cz, cy = z[::cw], labels["ids"][::cw].numpy()
    differ = {"qda": [], "lda": [], "logistic": []}
    retried = 0
    for tr, te in em.kfold_indices(len(cz), 5):
        preds = {}
        try:
            probes.qda_fit(torch.as_tensor(cz[tr]).to(DEVICE), torch.as_tensor(cy[tr]).to(DEVICE))
        except ValueError as e:
            if "full rank" not in str(e):
                raise
            retried += 1
        for d in devices:
            ztr, ytr, zte = (torch.as_tensor(a).to(d) for a in (cz[tr], cy[tr], cz[te]))
            preds[d] = {
                "qda": probes.qda_predict(em.qda_fit_retry(ztr, ytr), zte),
                "lda": probes.lda_predict(probes.lda_fit(ztr, ytr), zte),
                "logistic": probes.logistic_predict(ztr, ytr, zte),
            }
        for name in differ:
            differ[name].append(int((preds[DEVICE][name].cpu() != preds["cpu"][name]).sum()))
    rec.update({f"{name}_differing_per_fold": v for name, v in differ.items()})
    if any(differ["qda"]) or any(differ["lda"]) or max(differ["logistic"]) > 1:
        raise AssertionError(f"fit: card and CPU predictions differ: {differ}")
    rec["qda_retry_folds"] = retried

    # what shaped the estimators, read on this mu: the folds where QDA took
    # its retry (above), how far from isotropic a classification fold is and
    # the Newton iterations its logistic fit takes; how far apart the card
    # and the CPU land with the MLP probe trained in float32, not float64
    tr = em.kfold_indices(len(cz), 5)[0][0]
    xc = torch.as_tensor(cz[tr], device=DEVICE).double()
    sv = torch.linalg.svdvals(xc - xc.mean(0))
    rec["class_fold_singular_value_ratio"] = float(sv[0] / sv[-1])
    onehot = torch.nn.functional.one_hot(torch.unique(torch.as_tensor(cy[tr]), return_inverse=True)[1])
    rec["class_fold_logistic_iterations"] = probes.logistic_fit(xc, onehot.to(DEVICE).double())[2]
    dz, dy = z[::window], labels["avg_speed_3d"][::window]
    tr, te = em.kfold_indices(len(dz), 5)[0]
    r2 = {}
    for d in devices:
        model = probes.MLPProbe(probes.probe_init(z.shape[1], dy.shape[1]), device=d).float()
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.01)
        x, y = torch.as_tensor(dz[tr]).to(d), dy[tr].to(d).float()
        for _ in range(200):
            opt.zero_grad()
            ((model(x) - y) ** 2).sum().backward()
            opt.step()
        with torch.no_grad():
            r2[d] = probes.r2_score(dy[te], model(torch.as_tensor(dz[te]).to(d)).cpu())
    rec["mlp_float32_r2_card_cpu_diff"] = abs(r2[DEVICE] - r2["cpu"])
    return rec


def fit_phase(card: str, keep: pathlib.Path = None) -> dict:
    """``train(config, datasets, model, info)`` for epochs 11 to 20 at full
    flagship width, then a resume from epoch 20 for epoch 21 (see the
    module docstring). With ``keep``, the run's folder (config, weights at
    15 and 20) is moved there for the analysis phase."""
    import csv

    from scrubvae_torch import bench, factory
    from scrubvae_torch.evals import metrics as em
    from scrubvae_torch.train import trainer as trainer_mod
    from scrubvae_torch.utils import checkpoint as ckpt

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_fit_"))
    timer = _Timer()
    try:
        datasets = _fit_splits()
        n_train, n_val = len(datasets["train"]), len(datasets["val"])
        if n_train // 512 < 3 or n_val < 5000 or n_val % 512 == 0:
            raise AssertionError(f"fit: {n_train} train and {n_val} val windows")
        run = tmp / "run"
        config = _fit_config(run, model={"start_epoch": FIT_START})

        def build():
            return factory.build_model(
                config["model"], config["disentangle"], n_keypts=18, direction_process="midfwd",
                arena_size=bench.ARENA, discrete_classes=datasets["train"].discrete_classes,
                loss_keys=config["loss"].keys(), device=DEVICE,
            )

        model, info = build()
        for owner, name, label in (
            (trainer_mod.Trainer, "train_epoch", "train_epoch"),
            (trainer_mod.Trainer, "test_epoch", "val_epoch"),
            (ckpt, "save_weights", "save_weights"),
            (ckpt, "save_train_state", "save_train_state"),
            (ckpt, "load_weights", "load_weights"),
            (ckpt, "load_train_state", "load_train_state"),
            (trainer_mod.Trainer, "decodability_metrics", "decodability"),
            (em, "linear_rand_cv", "linear"),
            (em, "mlp_rand_cv", "mlp"),
            (em, "log_class_rand_cv", "logistic"),
            (em, "qda_rand_cv", "qda"),
        ):
            timer.wrap(owner, name, label)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer = trainer_mod.train(config, datasets, model, info, device=DEVICE)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        for w in caught:
            log(f"fit: warning during train: {w.category.__name__}: {w.message}")
        # read before the card-against-CPU comparison calls the estimators again
        n_eval = len(timer.times["decodability"])
        decod_ms = {k: timer.total_ms(k) / n_eval for k in ("linear", "mlp", "logistic", "qda")}
        launches = _launches()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        ended = _trainer_state(trainer)

        steps = trainer.steps_per_epoch * (FIT_EPOCHS - FIT_START)
        params = list(trainer.model.parameters())
        table = trainer.state.opt_state.table
        table.check_storage(params, trainer.state.opt_state.mu, trainer.state.opt_state.nu)
        if (len(params), len(table.w), len(table.batches)) != (FLAGSHIP_LEAVES, FLAGSHIP_LEAVES, 2):
            raise AssertionError(
                f"fit: {len(params)} leaves, a table of {len(table.w)} in {len(table.batches)} launches"
            )
        if launches != 2 * steps or trainer.state.opt_state.step != steps:
            raise AssertionError(f"fit: {launches} optimizer launches in {steps} steps; expected 2 a step")
        with open(run / "metrics.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        if [int(r["epoch"]) for r in rows] != list(range(FIT_START + 1, FIT_EPOCHS + 1)):
            raise AssertionError(f"fit: metrics.csv epochs {[r['epoch'] for r in rows]}")
        test_keys = ("total_test", "r2_gen_restrict_avg_speed_3d_test", "r2_gen_restrict_heading_test")
        for r in rows:
            if not math.isfinite(float(r["total_train"])):
                raise AssertionError(f"fit: total_train {r['total_train']} at epoch {r['epoch']}")
            if int(r["epoch"]) % 5 == 0 and not all(r[k] and math.isfinite(float(r[k])) for k in test_keys):
                raise AssertionError(f"fit: validation metrics at epoch {r['epoch']}: {[r[k] for k in test_keys]}")
        z20 = timer.last["decodability"][1]
        nanfolds = [k for k in rows[0] if k.endswith("_nanfolds")]
        missing = [k for k in DECOD_COLUMNS if k not in rows[0]]
        bad = [
            (r["epoch"], k, r[k]) for r in rows if int(r["epoch"]) % 5 == 0
            for k in DECOD_COLUMNS if k in r and not (r[k] and math.isfinite(float(r[k])))
        ]
        if nanfolds or missing or bad:
            out = ROOT / "chiprun_out"
            out.mkdir(exist_ok=True)
            full = datasets["val"].batch(torch.arange(n_val, device=DEVICE))
            np.savez(out / "fit_decodability_z.npz", z=z20, **{k: full[k].cpu().numpy() for k in ("avg_speed_3d", "heading", "ids")})
            raise AssertionError(
                f"fit: decodability columns: nan folds in {nanfolds}, missing {missing}, not finite {bad}; "
                f"the epoch-20 mu and labels are in {out / 'fit_decodability_z.npz'}"
            )
        card_cpu = decodability_card_vs_cpu(z20, datasets["val"], info["window"])
        log("fit decodability, card against CPU: " + json.dumps(card_cpu))
        if list(factory.all_saved_epochs(run)) != [15, 20] or sorted(
            p.name for p in (run / "checkpoints").iterdir()
        ) != ["epoch_20.pt"]:
            raise AssertionError("fit: weights at 15 and 20 and the full state at 20 expected")

        # resume from epoch 20
        config = _fit_config(
            tmp / "resume", num_epochs=FIT_EPOCHS + 1, model={"load_model": str(run), "start_epoch": FIT_EPOCHS}
        )
        model, info = build()
        resumed = trainer_mod.Trainer(config, datasets, model, info, device=DEVICE)
        bad = _same_state(_trainer_state(resumed), ended)
        if bad:
            raise AssertionError(f"fit: resume from epoch {FIT_EPOCHS} differs in {bad}")
        resumed.fit()
        with open(tmp / "resume" / "metrics.csv", newline="") as f:
            rows21 = list(csv.DictReader(f))
        if [r["epoch"] for r in rows21] != [str(FIT_EPOCHS + 1)] or not all(
            math.isfinite(float(v)) for k, v in rows21[0].items() if k.endswith("_train")
        ):
            raise AssertionError(f"fit: epoch {FIT_EPOCHS + 1} after the resume: {rows21}")

        epoch_ms = timer.mean_ms("train_epoch")
        rec = {
            "card": card, "epochs": FIT_EPOCHS - FIT_START, "train_windows": n_train, "val_windows": n_val,
            "steps_per_epoch": trainer.steps_per_epoch, "fit_s": fit_s,
            "train_epoch_ms": epoch_ms, "step_ms": epoch_ms / trainer.steps_per_epoch,
            "val_epoch_ms": timer.mean_ms("val_epoch"), "val_epochs": len(timer.times["val_epoch"]),
            "decodability_ms_per_val_epoch": timer.mean_ms("decodability"),
            "decodability_ms_per_val_epoch_by_probe": decod_ms,
            "decodability_epoch20": {k: float(rows[-1][k]) for k in DECOD_COLUMNS},
            "decodability_card_vs_cpu": card_cpu,
            "save_weights_ms": timer.mean_ms("save_weights"),
            "weights_bytes": (run / "weights" / "epoch_20.pt").stat().st_size,
            "save_train_state_ms": timer.mean_ms("save_train_state"),
            "train_state_bytes": (run / "checkpoints" / "epoch_20.pt").stat().st_size,
            "restore_ms": timer.mean_ms("load_weights") + timer.mean_ms("load_train_state"),
            "peak_mem_gib": peak_gib, "optimizer_launches": launches, "launches_per_step": launches / steps,
            "leaves": len(params), "resume_bitwise_equal": True,
            "first_total_train": float(rows[0]["total_train"]), "last_total_train": float(rows[-1]["total_train"]),
            "epoch21_total_train": float(rows21[0]["total_train"]),
            "r2_gen_restrict_epoch20": {k: float(rows[-1][k]) for k in test_keys[1:]},
        }
        log("fit flagship train entry point: " + json.dumps(rec))
        if keep is not None:
            shutil.move(str(run), str(keep))
        return rec
    finally:
        timer.undo()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 8: the full scrubber stack (configs/ladder/5_full.yaml)
# ---------------------------------------------------------------------------

FULL_EPOCHS = 20
FULL_PRINT_EPOCHS = (1, 5, 10, 20)
FULL_COLUMNS = ("avg_speed_3d_an", "ids_qda", "mcmi", "total_correlation")
ADV_FEAT = "avg_speed_3d"
# card against CPU: narrow channels, the flagship's z (QDA's 128-dim
# systems), f32, no clip (as the CPU tests: a clip factor below 1 makes the
# step-1 update of a small gradient depend on its value, not only its sign,
# which the weights' two-ulp bound assumes), and the parity phase's batch
# of 16: at batch 128 the
# rotation loss's f32 rounding (see scrubvae_torch/train/parity.py) put the
# median step-1 gradient difference at 1.008e-2, past its 1e-2 bound
FULL_PARITY = {"channel": [8, 8, 16, 16, 32], "z_dim": 128, "batch": 16}
# the discriminator after its 5 inner AdamW steps at lr 0.1, card against
# CPU, per leaf by relative norm and on the median leaf. Each inner step
# moves a weight by about lr times the sign of its gradient, so an element
# whose gradient is near 0 flips under any rounding, the more so in
# sane/4_full: sound runs read up to 2.1e-4 (5_full) and 2.27e-3
# (sane/4_full; its CPU reference moves by up to 3.55e-3 under a 1e-6
# perturbation of the discriminator's input), medians up to 4.2e-6; one
# inner step left out, or an inner lr of 0.09, reads 0.11 or more on the
# largest leaf and 0.10 or more on the median
# (tests/test_torch_port_adv_bounds.py reads both on the CPU)
ADV_TOL = {"ladder/5_full": 1e-3, "sane/4_full": 2e-2}
ADV_MEDIAN_TOL = 1e-4


def _shipped_config(run: pathlib.Path, name: str, model: dict = None, data: dict = None, **train) -> dict:
    """``configs/{name}.yaml`` with ``model``, ``data`` and ``train``
    entries overridden, written to ``run/model_config.yaml`` and read back
    through the port's config reader."""
    import yaml

    from scrubvae_torch.params import read

    with open(ROOT / "configs" / f"{name}.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["train"].update(train)
    cfg["model"].update(model or {})
    cfg["data"].update(data or {})
    run.mkdir(parents=True)
    (run / "model_config.yaml").write_text(yaml.safe_dump(cfg))
    return read.config(run / "model_config.yaml")


def _full_config(run: pathlib.Path, num_epochs: int = FULL_EPOCHS, model: dict = None, **train) -> dict:
    """configs/ladder/5_full.yaml with ``num_epochs`` and validation at
    epoch 20 only (see ``_shipped_config``)."""
    return _shipped_config(run, "ladder/5_full", model, num_epochs=num_epochs, eval_start_epoch=FULL_EPOCHS, **train)


def _full_parity_run(device: str, rows: np.ndarray, draws: list, name: str, z_dim: int) -> dict:
    """Two steps of the full stack of ``configs/{name}.yaml`` at
    ``FULL_PARITY``'s channels and batch and ``z_dim``, from the seed's
    weights and states, with the given rows, noise and shuffles (one inner
    discriminator step per shuffle); the step-1 gradients, weights and
    states, and both steps' losses, on the CPU."""
    from scrubvae_torch import bench, factory
    from scrubvae_torch.data.dataset import StreamDataset
    from scrubvae_torch.data.pipeline import build_frame_store
    from scrubvae_torch.data.skeleton import load_skeleton
    from scrubvae_torch.data.synthetic import synthetic_pose_stream
    from scrubvae_torch.train import parity
    from scrubvae_torch.train.trainer import Trainer

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_full_parity_"))
    try:
        config = _shipped_config(
            tmp / "run", name, model={"channel": FULL_PARITY["channel"], "z_dim": z_dim, "precision": "fp32"},
            precision="fp32", moment_dtype="f32", minimal_test=True, clip_norm=0,
        )
        config["data"]["batch_size"] = FULL_PARITY["batch"]
        dp = config["data"]["direction_process"]
        skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
        pose, ids = synthetic_pose_stream(skel, n_frames=4096, n_ids=4, seed=0)
        ds = StreamDataset(
            build_frame_store(pose, ids, skel, window=51, stride=2, device=device), skel, bench.KEYS, dp,
            arena_size=bench.ARENA, discrete_classes={"ids": np.unique(ids)}, device=device,
        )
        model, info = factory.build_model(
            config["model"], config["disentangle"], 18, dp, arena_size=bench.ARENA,
            discrete_classes=ds.discrete_classes, loss_keys=config["loss"].keys(), device=device,
        )
        trainer = Trainer(config, {"train": ds}, model, info, device=device)
        names = [n for n, _ in trainer.model.named_parameters()]
        loss_scale = trainer.loss_scale_for_epoch(26)  # the prior at half its weight
        out = {"losses": []}
        for s, (eps, perms) in enumerate(draws):
            perms = {"loss": perms["loss"].to(device), "fit": {k: [p.to(device) for p in v] for k, v in perms["fit"].items()}}
            trainer.state, metrics = trainer.train_step(
                trainer.state, torch.as_tensor(rows[s] % len(ds), device=device), loss_scale,
                eps=torch.from_numpy(eps).to(device), perms=perms,
            )
            out["losses"].append({k: float(v) for k, v in metrics.items()})
            if s == 0:
                # copies: step 2 updates the parameters and moments in place
                st = trainer.state

                def cpu(t):
                    return t.detach().to("cpu", copy=True)

                out["grads"] = {n: cpu(m) / (1.0 - trainer.tx.b1) for n, m in zip(names, st.opt_state.mu)}
                out["w1"] = {n: cpu(p) for n, p in trainer.model.named_parameters()}
                out["mals"] = {
                    feat: {k: cpu(getattr(m, k)) for k in parity.MALS_KEYS}
                    for feat, m in st.scrub_state["moving_avg_lsq"].items()
                }
                out["qda"] = {k: cpu(getattr(st.scrub_state["qda"]["ids"], k)) for k in parity.QDA_KEYS}
                out["adv"] = {k: cpu(v) for k, v in st.adv_states[ADV_FEAT].net.state_dict().items()}
                out["mi"] = {k: cpu(getattr(st.mi_state, k)) for k in parity.MI_KEYS}
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def full_parity_draws(z_dim: int):
    """The window rows of two steps (modulo the dataset's length) and each
    step's noise and permutations: the loss's shuffle and the
    discriminator's 5 inner shuffles."""
    B = FULL_PARITY["batch"]
    rng = np.random.default_rng(5)
    gen = torch.Generator().manual_seed(5)
    rows = rng.integers(0, 1 << 20, (2, B))
    draws = [
        (
            rng.standard_normal((B, z_dim)).astype(np.float32),
            {"loss": torch.randperm(B, generator=gen), "fit": {ADV_FEAT: [torch.randperm(B, generator=gen) for _ in range(5)]}},
        )
        for _ in range(2)
    ]
    return rows, draws


def skip_inner_step(draws: list) -> list:
    """Step 1 of ``draws`` with the discriminator's last inner step left
    out: a planted fault."""
    eps, perms = draws[0]
    return [(eps, {**perms, "fit": {ADV_FEAT: perms["fit"][ADV_FEAT][:4]}})]


def full_parity(name: str = "ladder/5_full", z_dim: int = FULL_PARITY["z_dim"]) -> dict:
    """The full stack's steps 1 and 2 of ``configs/{name}.yaml`` on the card
    against the CPU: step 1 held to ``scrubvae_torch.train.parity`` (losses
    1e-4, gradients, weights to four ulps, MALS of every feature and QDA
    1e-4, the discriminator by ``ADV_TOL``, MCMI 1e-2), step 2's losses,
    where QDA's and MCMI's are no longer 0, at rtol 1e-2. The card runs with
    deterministic algorithms. Then the same step 1 on the card with one of
    the discriminator's 5 inner steps left out, a planted fault that the
    discriminator's bounds must catch."""
    from scrubvae_torch.train import parity

    B, Z = FULL_PARITY["batch"], z_dim
    rows, draws = full_parity_draws(Z)
    adv_tol = ADV_TOL[name]
    cpu = _full_parity_run("cpu", rows, draws, name, Z)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        card = _full_parity_run(DEVICE, rows, draws, name, Z)
        fault = _full_parity_run(DEVICE, rows, skip_inner_step(draws), name, Z)["adv"]
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    fault_rec = parity.check_adv(cpu["adv"], fault, math.inf)
    if fault_rec["max_adv_rel"] <= adv_tol and fault_rec["median_adv_rel"] <= ADV_MEDIAN_TOL:
        raise AssertionError(f"{name}: an inner discriminator step left out passes the bounds: {fault_rec}")
    want0 = {k: v for k, v in cpu["losses"][0].items() if k != "mcmi"}
    got0 = {k: v for k, v in card["losses"][0].items() if k != "mcmi"}
    if cpu["losses"][0]["mcmi"] != 0.0 or card["losses"][0]["mcmi"] != 0.0:
        raise AssertionError("full: the mcmi loss is not 0 before the estimator's first refresh")
    checks = {
        "max_loss_rel_step1": lambda: parity.check_losses(want0, got0, 1e-4),
        "grads": lambda: parity.check_grads(cpu["grads"], card["grads"]),
        "weights": lambda: parity.check_weights(cpu["w1"], card["w1"], cpu["grads"], ulps=4),
        "max_mals_rel": lambda: max(parity.check_mals(cpu["mals"][f], card["mals"][f], 1e-4) for f in cpu["mals"]),
        "max_qda_rel": lambda: parity.check_qda(cpu["qda"], card["qda"], 1e-4),
        "adv": lambda: parity.check_adv(cpu["adv"], card["adv"], adv_tol, median_tol=ADV_MEDIAN_TOL),
        "max_mi_rel": lambda: parity.check_mi(cpu["mi"], card["mi"], 1e-2),
        "max_loss_rel_step2": lambda: parity.check_losses(cpu["losses"][1], card["losses"][1], 1e-2),
    }
    rec = {
        "config": name, "batch": B, "z_dim": Z, "channels": FULL_PARITY["channel"],
        "adv_tol": adv_tol, "adv_median_tol": ADV_MEDIAN_TOL,
        "adv_fault_max_rel": fault_rec["max_adv_rel"], "adv_fault_median_rel": fault_rec["median_adv_rel"],
    }
    failed = {}
    for label, check in checks.items():
        # every check runs, so one call shows all that differs; any failure
        # fails the phase below
        try:
            got = check()
        except AssertionError as e:
            failed[label] = str(e)
            continue
        rec.update(got if isinstance(got, dict) else {label: got})
    rec["step2_losses_card"] = {k: card["losses"][1][k] for k in ("ids_qda", "mcmi", "avg_speed_3d_an", "total_correlation")}
    if failed:
        raise AssertionError(f"{name}: card against CPU: {json.dumps(failed)}; readings {json.dumps(rec)}")
    log(f"{name} card against CPU, steps 1 and 2: " + json.dumps(rec))
    return rec


def inner_adamw_check(adv_state, label: str = "discriminator") -> dict:
    """The discriminator's leaf set (its shapes, random values, f32 with f32
    moments) in one call of the kernel, bitwise against the plain version;
    the call's time beside its bound, the plain version's and
    ``torch._fused_adamw_``'s over the same leaves."""
    from scrubvae_torch.ops import fused_adamw as fa

    params = list(adv_state.net.parameters())
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(p, scale):
        return torch.randn(p.shape, generator=gen, device="cuda") * scale

    ws = [randn(p, 0.1) for p in params]
    gs = [randn(p, 1e-2) for p in params]
    mus = [randn(p, 1e-3) for p in params]
    nus = [randn(p, 1e-2) ** 2 for p in params]
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, wd=1e-4)
    t = 3
    scal = torch.tensor([0.1, 1.0 - 0.9**t, 1.0 - 0.999**t, 1.0], dtype=torch.float32, device="cuda")
    lr, b1c, b2c, gscale = scal.unbind(0)
    table = fa.LeafTable([w.clone() for w in ws], [m.clone() for m in mus], [v.clone() for v in nus])
    fa.fused_adamw_multi(table, gs, scal, step=t, **hyper)
    refs = fa.fused_adamw_multi_reference(ws, gs, mus, nus, lr=lr, b1c=b1c, b2c=b2c, gscale=gscale, step=t, **hyper)
    torch.cuda.synchronize()
    err = 0.0
    for i, ref in enumerate(refs):
        err = max(err, _assert_bits(f"{label} leaf {i} {tuple(ws[i].shape)}", (table.w[i], table.mu[i], table.nu[i]), ref))
    n = sum(table.numel)
    bytes_moved = fa.leaf_bytes([w.shape for w in ws], 4, 4)
    lib = [[x.clone() for x in xs] for xs in (ws, gs, mus, nus)]
    steps = [torch.tensor(float(t), device="cuda") for _ in ws]
    calls = {
        "kernel": lambda: fa.fused_adamw_multi(table, gs, scal, step=t, **hyper),
        "plain": lambda: fa.fused_adamw_multi_reference(
            ws, gs, mus, nus, lr=lr, b1c=b1c, b2c=b2c, gscale=gscale, step=t, **hyper
        ),
        "library": lambda: torch._fused_adamw_(
            *lib, [], steps, lr=0.1, beta1=0.9, beta2=0.999, weight_decay=1e-4,
            eps=1e-8, amsgrad=False, maximize=False,
        ),
    }
    rec = {
        "leaves": len(ws), "elements": n, "launches_per_call": len(table.batches), "bitwise": True,
        "max_abs_err": err, "bytes": bytes_moved,
    }
    # a call this small is set by the host: its device time (profiler) is
    # what the kernel costs, its time between events what a caller waits
    for name, fn in calls.items():
        rec[f"{name}_ms"] = device_ms(fn)
        rec[f"{name}_call_ms"] = cuda_ms(fn, iters=50)
    rec["bound_ms"], rec["bound_by"] = _bound(bytes_moved, n)
    log(f"kernel fused_adamw {label} leaf set: " + json.dumps(rec))
    return rec


def full_phase(card: str) -> dict:
    """``configs/ladder/5_full.yaml`` at its full width through
    ``train(config, datasets, model, info)`` for 20 epochs on the fit
    phase's splits, one validation epoch at 20 (MCMI refresh, decodability);
    then a resume from epoch 20 against the run's own epoch 21 (see the
    module docstring)."""
    import csv

    from scrubvae_torch import bench, factory
    from scrubvae_torch.train import trainer as trainer_mod

    parity_rec = full_parity()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_full_"))
    timer = _Timer()
    try:
        datasets = _fit_splits()
        run = tmp / "run"
        config = _full_config(run)

        def build():
            return factory.build_model(
                config["model"], config["disentangle"], n_keypts=18, direction_process="midfwd",
                arena_size=bench.ARENA, discrete_classes=datasets["train"].discrete_classes,
                loss_keys=config["loss"].keys(), device=DEVICE,
            )

        model, info = build()
        if model.vae.packed_sigma:
            raise AssertionError("full: total_correlation needs the dense Cholesky head")
        for owner, name, label in (
            (trainer_mod.Trainer, "train_epoch", "train_epoch"),
            (trainer_mod.Trainer, "test_epoch", "val_epoch"),
            (trainer_mod.Trainer, "_refresh_eval_mi", "mi_refresh"),
            (trainer_mod.Trainer, "decodability_metrics", "decodability"),
        ):
            timer.wrap(owner, name, label)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        trainer = trainer_mod.train(config, datasets, model, info, device=DEVICE)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = _launches()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        at20 = _trainer_state(trainer)

        steps = trainer.steps_per_epoch * FULL_EPOCHS
        outer = trainer.state.opt_state.table
        adv = trainer.state.adv_states[ADV_FEAT]
        n_iter = int(config["disentangle"]["n_iter"])
        per_step = len(outer.batches) + n_iter * len(adv.opt_state.table.batches)
        n_params = len(list(trainer.model.parameters()))
        if (len(outer.w), len(adv.opt_state.table.w), len(adv.opt_state.table.batches)) != (n_params, 22, 1):
            raise AssertionError(
                f"full: outer table of {len(outer.w)} leaves for {n_params} parameters, discriminator "
                f"table of {len(adv.opt_state.table.w)} leaves in {len(adv.opt_state.table.batches)} launches"
            )
        if launches != per_step * steps or adv.opt_state.step != n_iter * steps:
            raise AssertionError(f"full: {launches} kernel launches in {steps} steps; expected {per_step} a step")

        with open(run / "metrics.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        if [int(r["epoch"]) for r in rows] != list(range(1, FULL_EPOCHS + 1)):
            raise AssertionError(f"full: metrics.csv epochs {[r['epoch'] for r in rows]}")
        loss_cols = [k for k in rows[0] if k.endswith("_train")]
        missing = [f"{c}_{s}" for c in FULL_COLUMNS for s in ("train", "test") if f"{c}_{s}" not in rows[0]]
        bad = [
            (r["epoch"], k, r[k]) for r in rows for k in loss_cols + ["lambda_qda_ids"]
            if not math.isfinite(float(r[k]))
        ]
        bad += [(20, k, rows[-1][k]) for k in rows[-1] if k.endswith("_test") and not math.isfinite(float(rows[-1][k]))]
        if missing or bad:
            raise AssertionError(f"full: metrics.csv columns missing {missing}, not finite {bad}")
        lam = [float(r["lambda_qda_ids"]) for r in rows]
        printed = {
            r["epoch"]: {k: float(r[k]) for k in ["lambda_qda_ids", "total_train"] + [f"{c}_train" for c in FULL_COLUMNS]}
            for r in rows if int(r["epoch"]) in FULL_PRINT_EPOCHS
        }
        printed["20"].update({f"{c}_test": float(rows[-1][f"{c}_test"]) for c in FULL_COLUMNS})
        log("full metrics.csv at epochs 1, 5, 10, 20: " + json.dumps(printed))
        epoch_ms = timer.mean_ms("train_epoch")
        rec = {
            "card": card, "epochs": FULL_EPOCHS, "batch": int(config["data"]["batch_size"]),
            "z_dim": int(config["model"]["z_dim"]), "channels": config["model"]["channel"],
            "steps_per_epoch": trainer.steps_per_epoch, "fit_s": fit_s,
            "train_epoch_ms": epoch_ms, "step_ms": epoch_ms / trainer.steps_per_epoch,
            "val_epoch_ms": timer.mean_ms("val_epoch"), "val_epochs": len(timer.times["val_epoch"]),
            "mi_refresh_ms": timer.mean_ms("mi_refresh"),
            "decodability_ms": timer.mean_ms("decodability"),
            "peak_mem_gib": peak_gib, "kernel_launches": launches, "launches_per_step": launches / steps,
            "inner_launches_per_step": n_iter * len(adv.opt_state.table.batches),
            "lambda_qda_ids_first_last": [lam[0], lam[-1]],
            "first_total_train": float(rows[0]["total_train"]), "last_total_train": float(rows[-1]["total_train"]),
        }
        timer.undo()
        inner = inner_adamw_check(adv)

        # epoch 21 of the run itself, then a resume from epoch 20, both with
        # deterministic algorithms
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True)
        try:
            trainer.start_epoch = FULL_EPOCHS
            trainer.fit(FULL_EPOCHS + 1)
            at21 = _trainer_state(trainer)
            del trainer
            resume_cfg = _full_config(
                tmp / "resume", num_epochs=FULL_EPOCHS + 1,
                model={"load_model": str(run), "start_epoch": FULL_EPOCHS},
            )
            model, info = build()
            resumed = trainer_mod.Trainer(resume_cfg, datasets, model, info, device=DEVICE)
            bad = _same_state(_trainer_state(resumed), at20)
            if bad:
                raise AssertionError(f"full: the state restored at epoch {FULL_EPOCHS} differs in {bad}")
            resumed.fit()
            bad = _same_state(_trainer_state(resumed), at21)
            if bad:
                raise AssertionError(f"full: epoch {FULL_EPOCHS + 1} after the resume differs in {bad}")
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False

        rec.update(resume_bitwise_equal=True, card_vs_cpu=parity_rec, inner_adamw=inner)
        log("full scrubber stack train entry point: " + json.dumps(rec))
        return rec
    finally:
        timer.undo()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 9: the port's bench entry
# ---------------------------------------------------------------------------


FLAGSHIP_GFLOPS = 468.47  # the flagship's counted step, 2*M*N*K


def bench_phase() -> dict:
    """``scrubvae_torch.bench.run`` at its defaults (the flagship, batch 512,
    bf16 storage, 5 warm-up and 100 timed steps, one more step under the
    cost counter); its JSON line, printed as ``python -m
    scrubvae_torch.bench`` prints it. Requires a finite total, 2 optimizer
    launches a step, 0 < mfu <= 1, the FLOPs within 0.1% of
    ``FLAGSHIP_GFLOPS``, 0 < bound <= step time, and the counted fused
    AdamW bytes equal to ``leaf_bytes`` over the flagship's table."""
    from scrubvae_torch import bench
    from scrubvae_torch.ops import fused_adamw as fa

    trainer, _ = bench.build(16, 51, 128, bench.FULL_CH, DEVICE)  # the flagship's leaves, a small stream
    params, mu = list(trainer.model.parameters()), trainer.state.opt_state.mu
    table_bytes = sum(fa.leaf_bytes([p.shape], p.element_size(), m.element_size()) for p, m in zip(params, mu))
    del trainer, params, mu
    torch.cuda.empty_cache()
    args = bench.parse_args([])
    _reset_launches()
    out = bench.run(args)
    launches = _launches()
    log(json.dumps(out))
    steps = args.warmup + args.steps + 1
    if launches != 2 * steps:
        raise AssertionError(f"bench: {launches} optimizer launches in {steps} steps; expected 2 a step")
    if not 0.0 < out.get("mfu", 0.0) <= 1.0:
        raise AssertionError(f"bench: mfu {out.get('mfu')} outside (0, 1]")
    if abs(out["gflops_per_step"] / FLAGSHIP_GFLOPS - 1.0) > 1e-3:
        raise AssertionError(f"bench: {out['gflops_per_step']} GFLOP a step; expected {FLAGSHIP_GFLOPS} within 0.1%")
    if not (out["bytes_per_step"] > 0 and 0.0 < out["bound_ms_per_step"] <= out["step_ms"]):
        raise AssertionError(
            f"bench: {out['bytes_per_step']} bytes, a bound of {out['bound_ms_per_step']} ms against a "
            f"{out['step_ms']} ms step"
        )
    adamw = out["step_cost"]["fused AdamW"]
    if (adamw["ops"], adamw["bytes"]) != (2, table_bytes):
        raise AssertionError(
            f"bench: the counter's fused AdamW {adamw['ops']} launches, {adamw['bytes']} bytes; "
            f"expected 2 and the table's {table_bytes}"
        )
    log(f"bench: bound {out['bound_ms_per_step']:.3f} ms, {out['bound_ms_per_step'] / out['step_ms']:.4f} of the "
        f"step; fused AdamW {adamw['bytes']} bytes = the table's leaf_bytes")
    return {**out, "optimizer_launches": launches, "launches_per_step": launches / steps,
            "adamw_table_bytes": table_bytes}


# ---------------------------------------------------------------------------
# phase 10: x360 windows, the encoder view, configs/sane and configs/sweep
# ---------------------------------------------------------------------------

# the structured stream at the size tools/run_ladder.py gives these configs:
# (seed, frames) per split, 4 ids
X360_SPLITS = {"train": (0, 24000), "val": (1, 8000)}
X360_RUNS = ("sweep/8_structural", "sane/4_full")
# one epoch, to keep the whole script within its time: validation runs at
# epochs divisible by 5, so the runs start at epoch 4 (model.start_epoch,
# nothing loaded) and validate at 5
X360_START, X360_EPOCHS = 4, 5
ENC_KEYS = ("x6d_enc", "root_enc")
ARENA_KEYS = ("root", "root_enc", "raw_pose")


def _structured(split: str):
    from scrubvae_torch.data.skeleton import load_skeleton
    from scrubvae_torch.data.synthetic import structured_pose_stream

    seed, frames = X360_SPLITS[split]
    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    return (skel, *structured_pose_stream(skel, n_frames=frames, n_ids=4, seed=seed))


def x360_windows_card_vs_cpu() -> dict:
    """``materialize`` of every key the port assembles (``raw_pose``,
    ``x6d_enc``, ``root_enc`` included) over the x360 windows of the
    structured val split, on the card against the CPU: atol 1e-5 (plus
    2e-6 of the vector's length for the keys in arena units), and for the
    keys built from IK (x6d, target_pose, x6d_enc) 1e-5 plus twice the
    CPU's own distance from float64, as the CPU tests hold the port to
    JAX. Then the window
    assembly of one batch of 64 with and without the view (the IK it runs
    again), timed on the card."""
    import dataclasses

    from scrubvae_torch import bench
    from scrubvae_torch.data.pipeline import SUPPORTED_KEYS, assemble_windows, build_frame_store, materialize
    from scrubvae_torch.ops import kinematics as kin
    from scrubvae_torch.ops import quaternion as qtn

    skel, pose, ids = _structured("val")
    stores = {d: build_frame_store(pose, ids, skel, window=51, stride=2, device=d) for d in (DEVICE, "cpu")}
    got = {d: materialize(st, skel.tree, SUPPORTED_KEYS, "x360") for d, st in stores.items()}
    cpu = stores["cpu"]
    p64 = cpu.pose.double()
    x6d64 = qtn.quaternion_to_cont6d(kin.inv_kin(p64, skel.tree, forward_indices=[1, 0]))
    tpose64 = kin.fwd_kin_cont6d(x6d64, skel.tree, cpu.offsets.double(), p64.new_zeros(len(p64), 3), eps=1e-8)
    s64 = dataclasses.replace(cpu, pose=p64, yaw=kin.frame_yaw(p64, 0, 1))
    enc64 = assemble_windows(s64, skel.tree, cpu.starts, ("x6d_enc",), "x360")["x6d_enc"]
    noise = {
        "x6d": float((cpu.x6d.double() - x6d64).abs().max()),
        "target_pose": float((cpu.tpose.double() - tpose64).abs().max()),
        "x6d_enc": float(np.abs(got["cpu"]["x6d_enc"] - enc64.numpy()).max()),
    }
    rec = {"windows": cpu.n_windows, "cpu_f64_distance": noise, "max_abs_diff": {}}
    bad = []
    for k in SUPPORTED_KEYS:
        a, b = got[DEVICE][k], got["cpu"][k]
        diff = np.abs(a.astype(np.float64) - b)
        rec["max_abs_diff"][k] = float(diff.max())
        # a rotation's rounding moves a vector's every entry by its length
        length = np.linalg.norm(b, axis=-1, keepdims=True) if k in ARENA_KEYS else 0.0
        tol = 1e-5 + 2 * noise.get(k, 0.0) + 2e-6 * length
        if a.shape != b.shape or a.dtype != b.dtype or not (diff <= tol).all():
            bad.append(k)
    if bad:
        raise AssertionError(f"x360: card and CPU windows differ in {bad}: {json.dumps(rec)}")
    rows = torch.randperm(cpu.n_windows, generator=torch.Generator().manual_seed(0))[:64]
    idx = stores[DEVICE].starts[rows.to(DEVICE)]
    for label, keys in (("assemble_ms_batch64_with_view", bench.KEYS + ENC_KEYS), ("assemble_ms_batch64_without_view", bench.KEYS)):
        rec[label] = cuda_ms(lambda: assemble_windows(stores[DEVICE], skel.tree, idx, keys, "x360"))
    log("x360 windows, card against CPU: " + json.dumps(rec))
    return rec


def _shipped_run(name: str, arrays: dict, card: str) -> dict:
    """``configs/{name}.yaml`` (its widths, batch and precision) through
    ``params.read.config``, ``factory.data_and_model`` and ``train(config,
    datasets, model, info)`` for the epochs after ``X360_START`` on
    ``arrays``, validating with decodability at 5. The card's machine
    has no ``h5py``: the split's pose file is an empty placeholder and
    ``factory.read_pose_h5`` serves its arrays from memory."""
    import csv

    from scrubvae_torch import factory
    from scrubvae_torch.train import trainer as trainer_mod

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_x360_"))
    timer = _Timer()
    read_pose_h5 = factory.read_pose_h5
    try:
        data = tmp / "data"
        for split in arrays:
            (data / "synthetic" / split).mkdir(parents=True)
            (data / "synthetic" / split / "pose.h5").touch()
        shutil.copy(ROOT / "configs" / "mouse_skeleton.yaml", data / "mouse_skeleton.yaml")
        run = tmp / "run"
        config = _shipped_config(
            run, name, model={"start_epoch": X360_START}, data={"data_path": str(data) + "/"},
            num_epochs=X360_EPOCHS, eval_start_epoch=X360_EPOCHS,
        )
        factory.read_pose_h5 = lambda path: arrays[pathlib.Path(path).parent.name]
        datasets, model, info = factory.data_and_model(
            config,
            data_keys=tuple(["x6d", "root", "offsets", "target_pose"] + list(config["disentangle"]["features"] or [])),
            device=DEVICE,
        )
        factory.read_pose_h5 = read_pose_h5
        for owner, fn, label in (
            (trainer_mod.Trainer, "train_epoch", "train_epoch"),
            (trainer_mod.Trainer, "test_epoch", "val_epoch"),
            (trainer_mod.Trainer, "decodability_metrics", "decodability"),
        ):
            timer.wrap(owner, fn, label)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        trainer = trainer_mod.train(config, datasets, model, info, device=DEVICE)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = _launches()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

        epochs = X360_EPOCHS - X360_START
        steps = trainer.steps_per_epoch * epochs
        n_iter = int(config["disentangle"].get("n_iter") or 5)
        inner = sum(n_iter * len(a.opt_state.table.batches) for a in trainer.state.adv_states.values())
        per_step = len(trainer.state.opt_state.table.batches) + inner
        if launches != per_step * steps:
            raise AssertionError(f"{name}: {launches} optimizer launches in {steps} steps; expected {per_step} a step")
        # the kernel over this run's own leaf tables (the outer one and each
        # discriminator's), bitwise against its plain version
        checks = [leaf_set_check(trainer, *_outer_hyper(), label=name)] + [
            inner_adamw_check(a, label=f"{name} discriminator {k}") for k, a in trainer.state.adv_states.items()
        ]
        view = all(set(ENC_KEYS) <= set(ds.data_keys) for ds in datasets.values())
        with open(run / "metrics.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        if [int(r["epoch"]) for r in rows] != list(range(X360_START + 1, X360_EPOCHS + 1)):
            raise AssertionError(f"{name}: metrics.csv epochs {[r['epoch'] for r in rows]}")
        last = rows[-1]
        tests = [k for k in last if k.endswith("_test")]
        bad = [
            (r["epoch"], k, r[k]) for r in rows for k in r
            if k.endswith("_train") and not math.isfinite(float(r[k]))
        ]
        bad += [(k, last.get(k)) for k in tests + list(DECOD_COLUMNS) if not (last.get(k) and math.isfinite(float(last[k])))]
        bad += [k for k in last if k.endswith("_nanfolds")]
        if bad or not tests:
            raise AssertionError(f"{name}: metrics.csv columns not finite or missing: {bad}")
        epoch_ms = timer.mean_ms("train_epoch")
        rec = {
            "config": name, "card": card, "epochs": epochs, "train_windows": len(datasets["train"]),
            "val_windows": len(datasets["val"]), "batch": trainer.batch_size,
            "channels": config["model"]["channel"], "z_dim": int(config["model"]["z_dim"]),
            "precision": config["train"]["precision"], "encoder_view": view,
            "direction_process": datasets["train"].direction_process, "model": config["model"]["type"],
            "steps_per_epoch": trainer.steps_per_epoch, "fit_s": fit_s,
            "train_epoch_ms": epoch_ms, "step_ms": epoch_ms / trainer.steps_per_epoch,
            "val_epoch_ms": timer.mean_ms("val_epoch"), "decodability_ms": timer.mean_ms("decodability"),
            "peak_mem_gib": peak_gib, "optimizer_launches": launches, "launches_per_step": launches / steps,
            "inner_launches_per_step": inner,
            "leaf_sets": [{k: c[k] for k in LEAF_SET_KEYS if k in c} for c in checks],
            "kernel_max_abs_err": max(c["max_abs_err"] for c in checks),
            "total_train": [float(r["total_train"]) for r in rows],
            "validation": {k: float(last[k]) for k in tests},
            "decodability": {k: float(last[k]) for k in DECOD_COLUMNS},
        }
        log(f"{name} train entry point: " + json.dumps(rec))
        return rec
    finally:
        factory.read_pose_h5 = read_pose_h5
        timer.undo()
        shutil.rmtree(tmp, ignore_errors=True)


def x360_phase(card: str) -> dict:
    """The x360 windows and the encoder view card against CPU, steps 1 and
    2 of configs/sane/4_full.yaml card against CPU, then 8_structural and
    4_full through the training entry point (see the module docstring)."""
    windows = x360_windows_card_vs_cpu()
    step = full_parity("sane/4_full", z_dim=32)
    arrays = {split: _structured(split)[1:] for split in X360_SPLITS}
    runs = {}
    for name in X360_RUNS:
        runs[name] = rec = _shipped_run(name, arrays, card)
        if rec["encoder_view"] != (name == "sweep/8_structural") or rec["direction_process"] != "x360":
            raise AssertionError(f"{name}: direction process {rec['direction_process']}, view {rec['encoder_view']}")
        torch.cuda.empty_cache()
    return {"windows": windows, "card_vs_cpu": step, "runs": runs}


# ---------------------------------------------------------------------------
# phase 11: the mlp and transformer model families and the scrubber branches
# ---------------------------------------------------------------------------

MLP_CONFIG = "ladder/1_vanilla_mlp"
TRANSFORMER = {"type": "transformer", "z_dim": 128, "window": 51, "diag": False}
# the transformer and branches runs train epochs 19 and 20 (model.start_epoch
# 18, nothing loaded): validation, decodability and the full state at 20
MODELS_START, MODELS_EPOCHS = 18, 20
# every branch this phase adds: MALS at polynomial 2, direct least squares
# with its bias column (a negative weight), gradient reversal on the ids
# under gr_legacy_norm and the moving-average class means of the ids
BRANCHES_METHODS = {
    "conditional": ["avg_speed_3d", "heading"],
    "moving_avg_lsq": ["avg_speed_3d"],
    "direct_lsq": ["heading"],
    "grad_reversal": ["ids"],
    "moving_avg": ["ids"],
}
BRANCHES_LOSS = {
    "rotation": 1.0, "prior": 0.001, "root": 0.01, "jpe": 1.0,
    "avg_speed_3d_mals": 0.1, "heading_lsq": -0.1, "ids_gr": 1.0, "ids_ma": 0.1,
}
# card against CPU: z 16, window 51, f32, no clip; batch 16, and 32 for the
# branches, whose least-squares system of 16 latents and the bias column
# needs more rows than columns
MODELS_PARITY_Z = 16
# the residual and positional dropout masks keep 0.9 of the entries within
# this over the flagship batch
KEPT_SHARE_TOL = 5e-3


def _models_config(out: pathlib.Path, batch: int, z_dim: int, ch, bf16_params: bool, model: dict = None,
                   branches: bool = False, precision: str = "bf16", **train) -> dict:
    """The flagship's config (``bench.bench_config``) with ``model`` and
    ``train`` entries overridden, and with the branches' method map and
    losses when ``branches``; writes to ``out``."""
    from scrubvae_torch import bench

    cfg = bench.bench_config(batch, 51, z_dim, ch, bf16_params, precision=precision)
    cfg["model"].update(model or {})
    cfg["train"].update(train)
    if branches:
        cfg["disentangle"].update(method=BRANCHES_METHODS, polynomial=2, gr_legacy_norm=True)
        cfg["loss"] = dict(BRANCHES_LOSS)
    cfg["out_path"] = str(out)
    return cfg


def _no_dropout(model) -> None:
    from scrubvae_torch.models import transformer as tr

    for m in model.modules():
        if isinstance(m, tr._Dropping):
            m.dropout = 0.0


def _models_parity_run(device: str, config: dict, rows: np.ndarray, eps: list) -> dict:
    """Two steps of ``config`` on ``device`` from the seed's weights (drawn
    on the CPU) with the given rows and noise, dropout off; the initial
    weights, step 1's gradients, weights and streaming states and both
    steps' losses, on the CPU; on the CPU also step 1's gradients in
    float64 (``parity.grads_float64``)."""
    from scrubvae_torch import bench, factory
    from scrubvae_torch.data.dataset import StreamDataset
    from scrubvae_torch.data.pipeline import build_frame_store
    from scrubvae_torch.data.skeleton import load_skeleton
    from scrubvae_torch.data.synthetic import synthetic_pose_stream
    from scrubvae_torch.train import parity
    from scrubvae_torch.train.trainer import Trainer

    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    pose, ids = synthetic_pose_stream(skel, n_frames=4096, n_ids=4, seed=0)
    ds = StreamDataset(
        build_frame_store(pose, ids, skel, window=51, stride=2, device=device), skel, bench.KEYS, "midfwd",
        arena_size=bench.ARENA, discrete_classes={"ids": np.unique(ids)}, device=device,
    )
    model, info = factory.build_model(
        config["model"], config["disentangle"], 18, "midfwd", arena_size=bench.ARENA,
        discrete_classes=ds.discrete_classes, loss_keys=config["loss"].keys(), device=device,
    )
    _no_dropout(model)
    trainer = Trainer(config, {"train": ds}, model, info, device=device)
    names = [n for n, _ in trainer.model.named_parameters()]
    keys = {"moving_avg_lsq": parity.MALS_KEYS, "moving_avg": parity.MA_KEYS}

    def cpu(t):
        return t.detach().to("cpu", copy=True)

    out = {"losses": [], "w0": {n: cpu(p) for n, p in trainer.model.named_parameters()}}
    if device == "cpu":
        out["grads64"] = parity.grads_float64(trainer, torch.as_tensor(rows[0] % len(ds)), torch.from_numpy(eps[0]))
    for s in range(2):
        trainer.state, metrics = trainer.train_step(
            trainer.state, torch.as_tensor(rows[s] % len(ds), device=device), trainer.loss_scale_for_epoch(1),
            eps=torch.from_numpy(eps[s]).to(device),
        )
        out["losses"].append({k: float(v) for k, v in metrics.items()})
        if s == 0:
            st = trainer.state
            out["grads"] = {n: cpu(m) / (1.0 - trainer.tx.b1) for n, m in zip(names, st.opt_state.mu)}
            out["w1"] = {n: cpu(p) for n, p in trainer.model.named_parameters()}
            out["states"] = {
                (method, feat): {k: cpu(getattr(state, k)) for k in keys[method]}
                for method in keys for feat, state in st.scrub_state.get(method, {}).items()
            }
    return out


def models_parity(label: str, model: dict, batch: int, branches: bool = False) -> dict:
    """Steps 1 and 2 on the card against the CPU at z 16, window 51, f32,
    without clip, with injected noise and dropout off on both sides: step 1
    held to ``scrubvae_torch.train.parity`` (losses 1e-4, gradients, weights
    to four ulps as the full stack's step, given both runs' gradients for
    the elements near Adam's eps and the CPU's float64 gradient as the
    witness of where the CPU's own f32 gradient has an unsure sign, the MALS and
    moving-average states 1e-4), step 2's losses at rtol 1e-2. The card
    runs with deterministic algorithms."""
    from scrubvae_torch import bench
    from scrubvae_torch.train import parity

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_models_parity_"))
    try:
        config = _models_config(
            tmp, batch, MODELS_PARITY_Z, bench.SMALL_CH, False, model=model, branches=branches, precision="fp32",
            moment_dtype="f32",
        )
        rng = np.random.default_rng(7)
        rows = rng.integers(0, 1 << 20, (2, batch))
        eps = [rng.standard_normal((batch, MODELS_PARITY_Z)).astype(np.float32) for _ in range(2)]
        cpu = _models_parity_run("cpu", config, rows, eps)
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True)
        try:
            card = _models_parity_run(DEVICE, config, rows, eps)
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def states(tol):
        worst = 0.0
        for (method, feat), want in cpu["states"].items():
            check = parity.check_mals if method == "moving_avg_lsq" else parity.check_ma
            worst = max(worst, check(want, card["states"][(method, feat)], tol))
        return worst

    checks = {
        "max_loss_rel_step1": lambda: parity.check_losses(cpu["losses"][0], card["losses"][0], 1e-4),
        "grads": lambda: parity.check_grads(cpu["grads"], card["grads"]),
        "weights": lambda: parity.check_weights(
            cpu["w1"], card["w1"], cpu["grads"], ulps=4, got_grads=card["grads"], unsure=unsure,
        ),
        "max_state_rel": lambda: states(1e-4),
        "max_loss_rel_step2": lambda: parity.check_losses(cpu["losses"][1], card["losses"][1], 1e-2),
    }
    unsure = parity.sign_unsure(cpu["grads"], cpu["grads64"])
    rec = {
        "run": label, "batch": batch, "z_dim": MODELS_PARITY_Z, "states": sorted(f"{m}/{f}" for m, f in cpu["states"]),
        "sign_unsure_elements": int(sum(int(m.sum()) for m in unsure.values())),
    }
    failed = {}
    for name, check in checks.items():
        # every check runs, so one call shows all that differs
        try:
            got = check()
        except AssertionError as e:
            failed[name] = str(e)
            continue
        rec.update(got if isinstance(got, dict) else {name: got})
    if failed:
        raise AssertionError(f"models {label}: card against CPU: {json.dumps(failed)}; readings {json.dumps(rec)}")
    rec["planted_sign_error_caught"] = planted_sign_error(cpu, card, unsure)
    log(f"models {label} card against CPU, steps 1 and 2: " + json.dumps(rec))
    return rec


def planted_sign_error(cpu: dict, card: dict, unsure: dict) -> str:
    """The card's step-1 update of its largest leaf with the sign reversed
    in the noise band of the CPU's gradient, where each element alone is
    excused: the weights' check of ``models_parity`` must raise on the
    flips' count. Returns the leaf."""
    from scrubvae_torch.train import parity

    n = max(cpu["w1"], key=lambda k: cpu["w1"][k].numel())
    g = cpu["grads"][n]
    band = g.abs() < 5e-2 * torch.sqrt(torch.mean(g * g))
    faulty = dict(card["w1"])
    faulty[n] = torch.where(band, 2 * card["w0"][n] - card["w1"][n], card["w1"][n])
    try:
        parity.check_weights(cpu["w1"], faulty, cpu["grads"], ulps=4, got_grads=card["grads"], unsure=unsure)
    except AssertionError as e:
        if "weights differ after step 1" in str(e):
            return n
        raise
    raise AssertionError(f"a sign error in the noise band of {n} ({int(band.sum())} elements) passed the weights' check")


def dropout_statistics(trainer, batch: dict) -> dict:
    """The transformer's dropout at its 0.1 rate on one flagship batch, in
    training mode with a generator of its own: every residual and
    positional mask keeps 0.9 of the nonzero entries within
    ``KEPT_SHARE_TOL``; a positional one scales the kept ones by 1/0.9
    (bitwise as the division on the card computes it), and a residual
    tail's kernel (``residual_norm``) gives the plain version's output with
    its mask within 4 f32 ulps at the output's scale; every attention mask
    is one (q, kv) mask for the whole batch and every head, scaling by
    1/0.9 within one f32 ulp. Then neither an eval-mode forward (twice,
    bitwise equal) nor the eval step draws a mask."""
    from scrubvae_torch.models import transformer as tr
    from scrubvae_torch.ops.residual_norm import residual_norm_reference

    calls = {"dropout": [], "attention": []}
    saved = (tr.dropout, tr.attention_dropout, tr.residual_norm)

    def residual(x, rate, generator):
        out = saved[0](x, rate, generator)
        nonzero, kept = x != 0, out != 0
        calls["dropout"].append({
            "shape": list(x.shape), "rate": rate, "kept_share": float(kept[nonzero].float().mean()),
            "scaled": bool(torch.equal(out[kept], (x / (1.0 - rate))[kept])),
        })
        return out

    def tail(x, y, keep, rate, weight, bias, eps):
        out = saved[2](x, y, keep, rate, weight, bias, eps)
        if keep is not None:
            ref = residual_norm_reference(x, y, keep, rate, weight, bias, eps)
            calls["dropout"].append({
                "shape": list(y.shape), "rate": rate, "kept_share": float(keep[y != 0].float().mean()),
                "scaled": float((out - ref).abs().max()) <= 4 * 2.0 ** -23 * float(ref.abs().max()),
            })
        return out

    def attention(w, rate, generator):
        out = saved[1](w, rate, generator)
        kept = out != 0
        scale = (out[kept] - w[kept] / (1.0 - rate)).abs() / (w[kept] / (1.0 - rate)).abs()
        calls["attention"].append({
            "shape": list(w.shape), "rate": rate, "kept_share": float(kept[:1, :1].float().mean()),
            "shared": bool(torch.equal(kept, kept[:1, :1].expand_as(kept))),
            "max_scale_rel": float(scale.max()),
        })
        return out

    model = trainer.model
    B = batch["x6d"].shape[0]
    try:
        tr.dropout, tr.attention_dropout, tr.residual_norm = residual, attention, tail
        model.train()
        with torch.no_grad():
            model(batch, eps=torch.zeros(B, model.vae.z_dim, device=DEVICE),
                  generator=torch.Generator(device=DEVICE).manual_seed(0))
        train_calls = {k: list(v) for k, v in calls.items()}
        calls["dropout"].clear()
        calls["attention"].clear()
        model.eval()
        with torch.no_grad():
            e1, e2 = (model(batch)["x6d"] for _ in range(2))
        idx = torch.arange(B, device=DEVICE)
        trainer.eval_step(trainer.state, idx, trainer.loss_scale_for_epoch(MODELS_EPOCHS), data=batch,
                          generator=torch.Generator(device=DEVICE).manual_seed(1))
    finally:
        tr.dropout, tr.attention_dropout, tr.residual_norm = saved
    n_layers = len(model.vae.encoder.transformer_encoder.layers)
    want = (2 + 2 * n_layers + 3 * n_layers, 3 * n_layers)
    shares = [c["kept_share"] for c in train_calls["dropout"]]
    rec = {
        "residual_positional_masks": len(train_calls["dropout"]), "attention_masks": len(train_calls["attention"]),
        "kept_share_min": min(shares), "kept_share_max": max(shares),
        "attention_kept_share": [c["kept_share"] for c in train_calls["attention"]],
        "attention_max_scale_rel": max(c["max_scale_rel"] for c in train_calls["attention"]),
        "eval_masks": len(calls["dropout"]) + len(calls["attention"]), "eval_bitwise_repeat": bool(torch.equal(e1, e2)),
    }
    bad = []
    if (rec["residual_positional_masks"], rec["attention_masks"]) != want:
        bad.append(f"{want} masks expected")
    bad += [c for c in train_calls["dropout"] if c["rate"] != 0.1 or not c["scaled"] or abs(c["kept_share"] - 0.9) > KEPT_SHARE_TOL]
    bad += [c for c in train_calls["attention"] if c["rate"] != 0.1 or not c["shared"] or c["max_scale_rel"] > 1.2e-7]
    if rec["eval_masks"] or not rec["eval_bitwise_repeat"]:
        bad.append("dropout in eval mode")
    if bad:
        raise AssertionError(f"models transformer dropout: {bad}; readings {json.dumps(rec)}")
    log("models transformer dropout at 0.1: " + json.dumps(rec))
    return rec


def _models_run(label: str, config: dict, datasets: dict, card: str, transformer: bool = False) -> dict:
    """``config`` through ``params.read.config`` and ``train(config,
    datasets, model, info)`` on the fit phase's splits for epochs 19 and 20
    (validation, decodability and the full state at 20): every loss column
    finite at every epoch, the validation losses and decodability finite at
    20, the optimizer's launches a step equal to its table's dtype
    variants (2), and its leaf table bitwise against the plain version
    (``leaf_set_check``). For the ``transformer``, the dropout statistics on
    one flagship batch (``dropout_statistics``), then the run's own epoch 21
    against a resume from epoch 20 with deterministic algorithms: the
    restored state and the epoch-21 state bit for bit, the dropout
    generator's included."""
    import csv

    from scrubvae_torch import bench, factory
    from scrubvae_torch.train import trainer as trainer_mod

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_models_"))
    timer = _Timer()
    try:
        def read_config(run, **model):
            return _write_config(run, dict(config, model=dict(config["model"], **model)))

        run = tmp / "run"
        cfg = read_config(run, start_epoch=MODELS_START)

        def build():
            return factory.build_model(
                cfg["model"], cfg["disentangle"], n_keypts=18, direction_process="midfwd",
                arena_size=bench.ARENA, discrete_classes=datasets["train"].discrete_classes,
                loss_keys=cfg["loss"].keys(), device=DEVICE,
            )

        model, info = build()
        for owner, name, tag in (
            (trainer_mod.Trainer, "train_epoch", "train_epoch"),
            (trainer_mod.Trainer, "test_epoch", "val_epoch"),
            (trainer_mod.Trainer, "decodability_metrics", "decodability"),
        ):
            timer.wrap(owner, name, tag)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        trainer = trainer_mod.train(cfg, datasets, model, info, device=DEVICE)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = _launches()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        timer.undo()
        at20 = _trainer_state(trainer) if transformer else None

        epochs = MODELS_EPOCHS - MODELS_START
        steps = trainer.steps_per_epoch * epochs
        per_step = len(trainer.state.opt_state.table.batches)
        if per_step != 2 or launches != per_step * steps:
            raise AssertionError(f"models {label}: {launches} optimizer launches in {steps} steps; expected 2 a step")
        check = leaf_set_check(trainer, *_outer_hyper(), label=f"models {label}")
        with open(run / "metrics.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        if [int(r["epoch"]) for r in rows] != list(range(MODELS_START + 1, MODELS_EPOCHS + 1)):
            raise AssertionError(f"models {label}: metrics.csv epochs {[r['epoch'] for r in rows]}")
        last = rows[-1]
        loss_cols = [f"{k}_train" for k in cfg["loss"]] + ["total_train"]
        tests = [k for k in last if k.endswith("_test")]
        bad = [(r["epoch"], k, r.get(k)) for r in rows for k in loss_cols if not (r.get(k) and math.isfinite(float(r[k])))]
        bad += [(k, last.get(k)) for k in tests + list(DECOD_COLUMNS) if not (last.get(k) and math.isfinite(float(last[k])))]
        bad += [k for k in last if k.endswith("_nanfolds")]
        if bad or not tests:
            raise AssertionError(f"models {label}: metrics.csv columns not finite or missing: {bad}")
        if sorted(p.name for p in (run / "checkpoints").iterdir()) != ["epoch_20.pt"]:
            raise AssertionError(f"models {label}: the full state at epoch 20 expected")
        epoch_ms = timer.mean_ms("train_epoch")
        rec = {
            "run": label, "card": card, "model": cfg["model"]["type"], "epochs": epochs,
            "train_windows": len(datasets["train"]), "val_windows": len(datasets["val"]), "batch": trainer.batch_size,
            "z_dim": int(cfg["model"]["z_dim"]), "param_dtype": cfg["train"]["param_dtype"],
            "methods": sorted(cfg["disentangle"]["method"]), "steps_per_epoch": trainer.steps_per_epoch,
            "fit_s": fit_s, "train_epoch_ms": epoch_ms, "step_ms": epoch_ms / trainer.steps_per_epoch,
            "val_epoch_ms": timer.mean_ms("val_epoch"), "decodability_ms": timer.mean_ms("decodability"),
            "peak_mem_gib": peak_gib, "optimizer_launches": launches, "launches_per_step": launches / steps,
            "leaf_set": {k: check[k] for k in LEAF_SET_KEYS},
            "kernel_max_abs_err": check["max_abs_err"],
            "loss_train": {k: [float(r[k]) for r in rows] for k in loss_cols},
            "validation": {k: float(last[k]) for k in tests},
            "decodability": {k: float(last[k]) for k in DECOD_COLUMNS},
        }
        if transformer:
            rec["dropout"] = dropout_statistics(trainer, datasets["train"].batch(torch.arange(512, device=DEVICE)))
            torch.backends.cudnn.deterministic = True
            torch.use_deterministic_algorithms(True)
            try:
                trainer.start_epoch = MODELS_EPOCHS
                trainer.fit(MODELS_EPOCHS + 1)
                at21 = _trainer_state(trainer)
                del trainer
                resume_cfg = read_config(tmp / "resume", load_model=str(run), start_epoch=MODELS_EPOCHS)
                resume_cfg["train"]["num_epochs"] = MODELS_EPOCHS + 1
                model, info = build()
                resumed = trainer_mod.Trainer(resume_cfg, datasets, model, info, device=DEVICE)
                bad = _same_state(_trainer_state(resumed), at20)
                if bad:
                    raise AssertionError(f"models {label}: the state restored at epoch {MODELS_EPOCHS} differs in {bad}")
                resumed.fit()
                bad = _same_state(_trainer_state(resumed), at21)
                if bad:
                    raise AssertionError(f"models {label}: epoch {MODELS_EPOCHS + 1} after the resume differs in {bad}")
            finally:
                torch.use_deterministic_algorithms(False)
                torch.backends.cudnn.deterministic = False
            rec["resume_bitwise_equal"] = True
        log(f"models {label} train entry point: " + json.dumps(rec))
        return rec
    finally:
        timer.undo()
        shutil.rmtree(tmp, ignore_errors=True)


def models_phase(card: str) -> dict:
    """The mlp and transformer model families and the scrubber branches
    (see the module docstring)."""
    from scrubvae_torch import bench

    arrays = {split: _structured(split)[1:] for split in X360_SPLITS}
    runs = {"mlp": _shipped_run(MLP_CONFIG, arrays, card)}
    if runs["mlp"]["model"] != "mlp" or runs["mlp"]["launches_per_step"] != 2:
        raise AssertionError(f"models mlp: {runs['mlp']['model']} model, {runs['mlp']['launches_per_step']} launches a step")
    torch.cuda.empty_cache()
    parity_recs = {
        "transformer": models_parity("transformer", {"type": "transformer"}, 16),
        "branches": models_parity("branches", {}, 32, branches=True),
    }
    datasets = _fit_splits()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_models_cfg_"))
    try:
        configs = {
            "transformer": _models_config(
                tmp, 512, 128, bench.FULL_CH, True, model=dict(TRANSFORMER), num_epochs=MODELS_EPOCHS,
                eval_start_epoch=0, minimal_test=None,
            ),
            "branches": _models_config(
                tmp, 512, 128, bench.FULL_CH, True, branches=True, num_epochs=MODELS_EPOCHS,
                eval_start_epoch=0, minimal_test=None,
            ),
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    runs["transformer"] = _models_run("transformer", configs["transformer"], datasets, card, transformer=True)
    torch.cuda.empty_cache()
    runs["branches"] = _models_run("branches", configs["branches"], datasets, card)
    torch.cuda.empty_cache()
    return {"runs": runs, "card_vs_cpu": parity_recs}


# ---------------------------------------------------------------------------
# phase 12: the rest of the training config surface
# ---------------------------------------------------------------------------

# epochs 19 and 20 (model.start_epoch 18, nothing loaded): validation, and
# the full state, at 20
SURFACE_START, SURFACE_EPOCHS = 18, 20
PARKINSONS_RAW_IDS = (0, 1, 2, 3, 36, 37, 38, 39)  # recoded 0 to 3; pd_label 0, 0, 0, 0, 1, 1, 1, 1
PARKINSONS_KEYS = ("x6d", "root", "offsets", "target_pose", "avg_speed_3d", "heading", "fluorescence", "pd_label")
PARKINSONS_COLUMNS = ("ids", "pd_label", "fluorescence")
PD_DECOD_COLUMNS = tuple(f"acc_{k}_{m}_{s}" for k in ("ids", "pd_label") for m in ("log", "qda") for s in ("mean", "std"))
SURFACE_RANK = 256
SURFACE_BATCH, SURFACE_Z = 512, 128  # the flagship's
SURFACE_VARIANTS = 2  # the kernel's launches a step at these widths: bf16 and f32 leaves
# (leaves, parameters) of the flagship's tables (bench.build at full width)
LOW_RANK_TABLE = (132, 22_654_604)
BETA_TABLE = (130, 20_008_396)
SURFACE_BENCH = (("default", []), ("sigma_rank", ["--sigma-rank"]), ("host_stream", ["--host-stream"]),
                 ("f32_params", ["--f32-params"]), ("no_fused", ["--no-fused", "--f32-params"]))
SURFACE_BENCH_STEPS = ["--steps", "20", "--warmup", "3"]
SURFACE_SLAB_BATCHES = 3


def parkinsons_config(data_path) -> dict:
    """The flagship's config on the parkinsons data, fluorescence among the
    scrubbed features (linear, MALS and gradient reversal on avg_speed_3d
    and fluorescence, decoding conditional on avg_speed_3d and heading),
    epochs 19 and 20 with validation and decodability at 20."""
    from scrubvae_torch import bench

    cfg = bench.bench_config(SURFACE_BATCH, 51, SURFACE_Z, bench.FULL_CH, True)
    del cfg["train"]["minimal_test"]
    cfg["data"].update(dataset="parkinsons", data_path=str(data_path) + "/")
    scrubbed = ["avg_speed_3d", "fluorescence"]
    cfg["disentangle"]["method"].update(linear=scrubbed, moving_avg_lsq=scrubbed, grad_reversal=scrubbed)
    cfg["disentangle"]["features"] = ["avg_speed_3d", "heading", "fluorescence"]
    cfg["loss"].update(fluorescence_lin=1.0, fluorescence_mals=0.1, fluorescence_gr=1.0)
    cfg["model"]["start_epoch"] = SURFACE_START
    cfg["train"].update(num_epochs=SURFACE_EPOCHS, eval_start_epoch=0)
    return cfg


def parkinsons_stream(split: str):
    """8 animals, raw ids 0 to 3 and 36 to 39: train 8 x 600 frames (2200
    windows), val 8 x 1300 (5100), as the fit phase's splits."""
    from scrubvae_torch.data.skeleton import load_skeleton
    from scrubvae_torch.data.synthetic import synthetic_pose_stream

    seed, per_id = {"train": (0, 600), "val": (1, 1300)}[split]
    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    pose, ids = synthetic_pose_stream(skel, n_frames=per_id * 8, n_ids=8, seed=seed)
    return skel, pose, np.asarray(PARKINSONS_RAW_IDS)[ids]


def _launches() -> int:
    """The fused AdamW kernel's launches since ``_reset_launches``."""
    from scrubvae_torch.ops import fused_adamw as fa

    return fa.fused_adamw_multi.launches


def _reset_launches() -> None:
    from scrubvae_torch.ops import fused_adamw as fa

    fa.fused_adamw_multi.launches = 0


def _surface_run(label: str, cfg: dict, build, card: str, run: pathlib.Path, fused: bool = True,
                 resume: bool = True, decod_columns=DECOD_COLUMNS) -> tuple:
    """``build(cfg) -> (datasets, model, info)`` (``factory.data_and_model``
    on the caller's data), then ``train(cfg, datasets, model, info)``:
    every loss column finite, the validation losses and the decodability
    columns (unless ``train.minimal_test``) finite at the last epoch, the
    fused kernel's launches a step equal to its table's dtype variants (2),
    or 0 when ``fused`` is False, the full state at 20; with ``resume``,
    the run's own epoch 21 against a resume from epoch 20, bit for bit.
    Deterministic algorithms throughout. Returns (record, trainer,
    datasets)."""
    import csv

    from scrubvae_torch.train import trainer as trainer_mod

    timer = _Timer()
    try:
        datasets, model, info = build(cfg)
        for owner, fn, tag in (
            (trainer_mod.Trainer, "train_epoch", "train_epoch"),
            (trainer_mod.Trainer, "test_epoch", "val_epoch"),
            (trainer_mod.Trainer, "decodability_metrics", "decodability"),
        ):
            timer.wrap(owner, fn, tag)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True)
        t0 = time.perf_counter()
        trainer = trainer_mod.train(cfg, datasets, model, info, device=DEVICE)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = _launches()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        epochs = int(cfg["train"]["num_epochs"]) - SURFACE_START
        steps = trainer.steps_per_epoch * epochs
        per_step = len(trainer.state.opt_state.table.batches) if fused else 0
        if launches != per_step * steps or (fused and per_step != SURFACE_VARIANTS):
            raise AssertionError(f"surface {label}: {launches} kernel launches in {steps} steps; expected {per_step} a step")
        with open(run / "metrics.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        last = rows[-1]
        loss_cols = [f"{k}_train" for k in cfg["loss"]] + ["total_train"]
        tests = [k for k in last if k.endswith("_test")]
        decod = [] if cfg["train"].get("minimal_test") or not tests else list(decod_columns)
        bad = [(r["epoch"], k, r.get(k)) for r in rows for k in loss_cols if not (r.get(k) and math.isfinite(float(r[k])))]
        bad += [(k, last.get(k)) for k in tests + decod if not (last.get(k) and math.isfinite(float(last[k])))]
        bad += [k for k in last if k.endswith("_nanfolds")]
        if bad or (epochs > 1 and not tests):
            raise AssertionError(f"surface {label}: metrics.csv columns not finite or missing: {bad}")
        epoch_ms = timer.mean_ms("train_epoch")
        rec = {
            "run": label, "card": card, "epochs": epochs, "train_windows": len(datasets["train"]),
            "val_windows": len(datasets["val"]), "batch": trainer.batch_size, "steps_per_epoch": trainer.steps_per_epoch,
            "dataset": type(datasets["train"]).__name__, "optimizer": type(trainer.tx).__name__,
            "leaves": len(list(trainer.model.parameters())),
            "parameters": sum(p.numel() for p in trainer.model.parameters()),
            "fit_s": fit_s, "train_epoch_ms": epoch_ms, "step_ms": epoch_ms / trainer.steps_per_epoch,
            "val_epoch_ms": timer.mean_ms("val_epoch") if "val_epoch" in timer.times else None,
            "decodability_ms": timer.mean_ms("decodability") if decod else None,
            "peak_mem_gib": peak_gib, "kernel_launches": launches, "launches_per_step": launches / steps,
            "loss_train": {k: [r[k] for r in rows] for k in loss_cols},
            "validation": {k: float(last[k]) for k in tests},
            "decodability": {k: float(last[k]) for k in decod},
        }
        if resume:
            if sorted(p.name for p in (run / "checkpoints").iterdir()) != ["epoch_20.pt"]:
                raise AssertionError(f"surface {label}: the full state at epoch 20 expected")
            at20 = _trainer_state(trainer)
            trainer.start_epoch = SURFACE_EPOCHS
            trainer.fit(SURFACE_EPOCHS + 1)
            at21 = _trainer_state(trainer)
            rcfg = _write_config(run.parent / f"{run.name}_resume", dict(cfg, model=dict(
                cfg["model"], load_model=str(run), start_epoch=SURFACE_EPOCHS)))
            rcfg["train"]["num_epochs"] = SURFACE_EPOCHS + 1
            rdatasets, rmodel, rinfo = build(rcfg)
            resumed = trainer_mod.Trainer(rcfg, rdatasets, rmodel, rinfo, device=DEVICE)
            bad = _same_state(_trainer_state(resumed), at20)
            if bad:
                raise AssertionError(f"surface {label}: the state restored at epoch 20 differs in {bad}")
            resumed.fit()
            bad = _same_state(_trainer_state(resumed), at21)
            if bad:
                raise AssertionError(f"surface {label}: epoch 21 after the resume differs in {bad}")
            rec["resume_bitwise_equal"] = True
        log(f"surface {label} train entry point: " + json.dumps(rec))
        return rec, trainer, datasets
    finally:
        timer.undo()
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


def _columns(ds) -> dict:
    """The recoded ids, pd_label and fluorescence of every window, on the CPU."""
    out = ds.batch(torch.arange(len(ds), device=ds.device))
    return {k: out[k].cpu() for k in PARKINSONS_COLUMNS}


def parkinsons_runs(card: str, tmp: pathlib.Path) -> dict:
    """Run 1: the parkinsons split files made by the port's
    ``preprocess_data`` functions on the card and served from memory
    through ``factory.read_key_h5``, trained with validation and
    decodability, resumed bitwise; the recoded columns equal to the CPU's
    loader's on the same files. Run 2: the same recordings as raw pose
    files (``factory.read_pose_h5``), a ``StreamDataset`` with the columns
    as extras: equal to run 1's, window for window; one epoch trained."""
    import shutil as _shutil

    from scrubvae_torch import factory, preprocess_data

    streams = {split: parkinsons_stream(split) for split in ("train", "val")}
    t0 = time.perf_counter()
    files = {split: preprocess_data.preprocess_split(pose, ids, skel, device=DEVICE)
             for split, (skel, pose, ids) in streams.items()}
    torch.cuda.synchronize()
    preprocess_s = time.perf_counter() - t0
    data = tmp / "parkinsons_data"
    for split in streams:
        (data / "parkinsons" / split).mkdir(parents=True)
    _shutil.copy(ROOT / "configs" / "mouse_skeleton.yaml", data / "mouse_skeleton.yaml")
    (data / "parkinsons" / "metadata.csv").write_text(
        "Subject,Fluorescence\n" + "".join(f"{i},{1.0 + 0.37 * i}\n" for i in range(40))
    )
    read_key_h5, read_pose_h5 = factory.read_key_h5, factory.read_pose_h5

    def build(cfg):
        return factory.data_and_model(cfg, data_keys=PARKINSONS_KEYS, use_default_val_keys=False, device=DEVICE)

    try:
        factory.read_key_h5 = lambda path, key: files[pathlib.Path(path).parent.name][key]
        cfg = _write_config(tmp / "parkinsons", parkinsons_config(data))
        per_key, trainer, datasets = _surface_run("parkinsons per-key", cfg, build, card, tmp / "parkinsons",
                                                  decod_columns=PD_DECOD_COLUMNS)
        per_key["preprocess_s"] = preprocess_s
        per_key["leaf_set"] = leaf_set_check(trainer, *_outer_hyper(), label="parkinsons")
        cols = {split: _columns(ds) for split, ds in datasets.items()}
        del trainer, datasets
        torch.cuda.empty_cache()
        cpu = {split: _columns(factory.mouse_data(cfg["data"], split, data_keys=PARKINSONS_KEYS, device="cpu"))
               for split in files}
        for split in files:
            for k in PARKINSONS_COLUMNS:
                if not torch.equal(cols[split][k], cpu[split][k]):
                    raise AssertionError(f"parkinsons {split}: the card's {k} column differs from the CPU's")
        raw = cols["val"]["ids"]
        per_key["columns"] = {
            "ids": sorted(set(cols["train"]["ids"].tolist())), "pd_label": sorted(set(cols["train"]["pd_label"][:, 0].tolist())),
            "fluorescence": sorted(set(cols["train"]["fluorescence"][:, 0].tolist())), "val_windows": len(raw),
        }
        factory.read_key_h5 = read_key_h5

        for split in streams:
            (data / "parkinsons" / split / "pose.h5").touch()
        factory.read_pose_h5 = lambda path: streams[pathlib.Path(path).parent.name][1:]
        cfg2 = parkinsons_config(data)
        cfg2["train"].update(num_epochs=SURFACE_START + 1)
        cfg2 = _write_config(tmp / "parkinsons_raw", cfg2)
        raw_rec, trainer, datasets = _surface_run("parkinsons raw pose", cfg2, build, card, tmp / "parkinsons_raw",
                                                  resume=False, decod_columns=PD_DECOD_COLUMNS)
        for split, ds in datasets.items():
            if set(ds.extras) != set(PARKINSONS_COLUMNS):
                raise AssertionError(f"parkinsons raw {split}: extras {sorted(ds.extras)}")
            got = _columns(ds)
            for k in PARKINSONS_COLUMNS:
                if not torch.equal(got[k], cols[split][k]):
                    raise AssertionError(f"parkinsons {split}: the raw-pose {k} column differs from the per-key one")
        raw_rec["columns_equal_per_key"] = True
        del trainer, datasets
        torch.cuda.empty_cache()
        return {"per_key": per_key, "raw_pose": raw_rec}
    finally:
        factory.read_key_h5, factory.read_pose_h5 = read_key_h5, read_pose_h5


def host_stream_runs(card: str, tmp: pathlib.Path) -> dict:
    """The flagship with ``data.host_stream: true`` on the fit phase's
    splits (served through ``factory.read_pose_h5``): the first slab
    batches of an epoch, through ``prefetch_to_device`` on its side stream,
    bitwise equal to the device-resident dataset's for the same indices;
    then its epochs 19 and 20 (validation and decodability at 20) against
    the device-resident run from the same seeds (``minimal_test``), the
    loss columns bit for bit (deterministic algorithms). Prints the step
    times with and without the stream, the consumer's wait on the copy a
    step, and per slab its size, the worker's gather and copy issue (host
    clock) and the copy itself (device)."""
    import shutil as _shutil

    from scrubvae_torch import factory
    from scrubvae_torch.data.dataset import epoch_index_matrix
    from scrubvae_torch.data.hoststream import prefetch_to_device
    from scrubvae_torch.data.skeleton import load_skeleton
    from scrubvae_torch.data.synthetic import synthetic_pose_stream

    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    arrays = {}
    for split, seed, per_id in (("train", 0, 1200), ("val", 1, 2600)):
        arrays[split] = synthetic_pose_stream(skel, n_frames=per_id * 4, n_ids=4, seed=seed)
    data = tmp / "stream_data"
    for split in arrays:
        (data / "synthetic" / split).mkdir(parents=True)
        (data / "synthetic" / split / "pose.h5").touch()
    _shutil.copy(ROOT / "configs" / "mouse_skeleton.yaml", data / "mouse_skeleton.yaml")
    read_pose_h5 = factory.read_pose_h5
    keys = ("x6d", "root", "offsets", "target_pose", "avg_speed_3d", "heading")

    def config(run, host: bool):
        from scrubvae_torch import bench

        cfg = bench.bench_config(SURFACE_BATCH, 51, SURFACE_Z, bench.FULL_CH, True)
        cfg["data"].update(data_path=str(data) + "/", host_stream=host)
        cfg["model"]["start_epoch"] = SURFACE_START
        cfg["train"].update(num_epochs=SURFACE_EPOCHS, eval_start_epoch=0, minimal_test=None if host else True)
        return _write_config(run, cfg)

    def build(cfg):
        return factory.data_and_model(cfg, data_keys=keys, device=DEVICE)

    try:
        factory.read_pose_h5 = lambda path: arrays[pathlib.Path(path).parent.name]
        hcfg = config(tmp / "host", True)
        dcfg = config(tmp / "device", False)
        hds = build(hcfg)[0]["train"]
        dds = build(dcfg)[0]["train"]
        rows = epoch_index_matrix(len(dds), SURFACE_BATCH, np.random.default_rng(0))[:SURFACE_SLAB_BATCHES]
        for i, slab in enumerate(prefetch_to_device(hds.epoch_slabs(rows), size=2, device=DEVICE)):
            got = hds.make_batch_fn()(slab)
            want = dds.batch(torch.as_tensor(rows[i], device=DEVICE))
            bad = [k for k in want if not (bits_equal(got[k], want[k]) if want[k].is_floating_point() else torch.equal(got[k], want[k]))]
            if bad or set(got) != set(want):
                raise AssertionError(f"host stream: slab batch {i} differs from the device-resident batch in {bad}")
        del hds, dds
        host, htrainer, _ = _surface_run("host stream", hcfg, build, card, tmp / "host", resume=False)
        stats = dict(htrainer.stream_stats)
        # the same gathers alone on this thread, with the card idle
        t0 = time.perf_counter()
        slabs = [htrainer.train_ds.host_batch(r) for r in rows]
        gather_alone_ms = (time.perf_counter() - t0) / len(rows) * 1e3
        slab_mb = sum(v.numel() * v.element_size() for v in slabs[0].values()) / 1e6
        del slabs
        del htrainer
        device, dtrainer, _ = _surface_run("device resident", dcfg, build, card, tmp / "device", resume=False)
        del dtrainer
        torch.cuda.empty_cache()
    finally:
        factory.read_pose_h5 = read_pose_h5
    if host["loss_train"] != device["loss_train"]:
        raise AssertionError(f"host stream: losses {host['loss_train']} against device-resident {device['loss_train']}")
    rec = {
        "slab_batches_bitwise": SURFACE_SLAB_BATCHES, "losses_bitwise_equal": True, "card": card,
        "step_ms_host_stream": host["step_ms"], "step_ms_device_resident": device["step_ms"],
        "copy_wait_ms_per_step": stats["wait_s"] / stats["items"] * 1e3, "slabs": stats["items"],
        # the worker's side of each slab: the gather on the host, the copy's
        # issue (host clock) and the copy itself (device, timing events)
        "gather_ms_per_slab": stats["gather_s"] / stats["items"] * 1e3,
        "issue_ms_per_slab": stats["issue_s"] / stats["items"] * 1e3,
        "copy_device_ms_per_slab": stats["copy_ms"] / stats["items"], "slab_mb": slab_mb,
        "gather_alone_ms_per_slab": gather_alone_ms,
        "host_stream_run": host, "device_run": device,
    }
    log("surface host stream against device resident: " + json.dumps({k: v for k, v in rec.items() if not k.endswith("_run")}))
    return rec


def surface_bench() -> dict:
    """``python -m scrubvae_torch.bench`` (20 timed steps after 3) at its
    defaults, with ``--sigma-rank 256``, ``--host-stream``,
    ``--f32-params`` and ``--no-fused --f32-params``, one after another on
    this card; the kernel's launches a step (2, and 0 with ``--no-fused``),
    the tables' leaves and parameters. The low-rank table (132 leaves,
    22,654,604 parameters) goes through the kernel in one call, bitwise
    against the plain version."""
    from scrubvae_torch import bench

    out = {}
    for name, flags in SURFACE_BENCH:
        args = bench.parse_args(SURFACE_BENCH_STEPS + flags + ([str(SURFACE_RANK)] if name == "sigma_rank" else []))
        _reset_launches()
        rec = bench.run(args)
        launches = _launches()
        steps = args.warmup + args.steps + 1
        want = 0 if args.no_fused else SURFACE_VARIANTS
        if launches != want * steps or not math.isfinite(rec["total"]):
            raise AssertionError(f"bench {name}: {launches} kernel launches in {steps} steps, total {rec['total']}")
        rec["launches_per_step"] = launches / steps
        if name == "sigma_rank":
            if (rec["leaves"], rec["parameters"]) != LOW_RANK_TABLE:
                raise AssertionError(f"bench sigma_rank: {rec['leaves']} leaves, {rec['parameters']} parameters")
            trainer, _ = bench.build(SURFACE_BATCH, 51, SURFACE_Z, bench.FULL_CH, DEVICE, sigma_rank=SURFACE_RANK)
            rec["leaf_set"] = leaf_set_check(trainer, *_outer_hyper(), label="low-rank")
            del trainer
        torch.cuda.empty_cache()
        log(f"surface bench {name}: " + json.dumps(rec))
        out[name] = rec
    return out


def _flagship_variant(tmp: pathlib.Path, label: str, model: dict = None, **train) -> dict:
    from scrubvae_torch import bench

    cfg = bench.bench_config(SURFACE_BATCH, 51, SURFACE_Z, bench.FULL_CH, train.pop("bf16_params", True))
    cfg["model"].update(model or {}, start_epoch=SURFACE_START)
    cfg["train"].update(num_epochs=SURFACE_EPOCHS, eval_start_epoch=0, **train)
    return _write_config(tmp / label, cfg)


def optimizer_prior_runs(card: str, tmp: pathlib.Path) -> dict:
    """The flagship with ``model.prior: beta`` (dense head), with
    ``train.optimizer: sgd`` (``train.clip_norm: 1``) and with
    ``train.fused_optimizer: false``
    (f32 storage, bf16 moments on the leaves of 65536 or more): epochs 19
    and 20 on the fit phase's splits, validation at 20 (no decodability:
    ``minimal_test``), the resume bitwise; the kernel's launches 2 a step
    for the beta prior and 0 for sgd and the unfused Adam. The beta-prior
    table (130 leaves, 20,008,396 parameters) goes through the kernel in
    one call, bitwise against the plain version."""
    from scrubvae_torch import factory

    datasets = _fit_splits()
    runs = {
        "beta_prior": (dict(prior="beta"), dict(), True),
        # at the default clip (1e6) one sgd step at lr 1e-4 on the summed
        # losses (root about 2e6) blows the root loss up, in JAX as in the
        # port (tests/test_torch_port_sgd_steps.py): the global-norm clip at 1
        "sgd": (None, dict(optimizer="sgd", bf16_params=False, clip_norm=1.0), False),
        "unfused_adam": (None, dict(fused_optimizer=False, bf16_params=False), False),
    }
    out = {}
    for label, (model, train, fused) in runs.items():
        cfg = _flagship_variant(tmp, label, model, minimal_test=True, **train)

        def build(c):
            m, info = factory.build_model(
                c["model"], c["disentangle"], n_keypts=18, direction_process="midfwd", arena_size=datasets["train"].arena_size,
                discrete_classes=datasets["train"].discrete_classes, loss_keys=c["loss"].keys(), device=DEVICE,
            )
            return datasets, m, info

        rec, trainer, _ = _surface_run(label, cfg, build, card, tmp / label, fused=fused)
        if label == "beta_prior":
            if trainer.model.vae.packed_sigma or (rec["leaves"], rec["parameters"]) != BETA_TABLE:
                raise AssertionError(f"beta prior: {rec['leaves']} leaves, {rec['parameters']} parameters")
            rec["leaf_set"] = leaf_set_check(trainer, *_outer_hyper(), label="beta prior")
        else:
            rec["moment_dtypes"] = sorted({str(m.dtype) for m in getattr(trainer.state.opt_state, "mu", [])})
        del trainer
        torch.cuda.empty_cache()
        out[label] = rec
    return out


def _surface_parity_run(device: str, config: dict, rows: np.ndarray, draws: list, bits: list = None) -> dict:
    """Two steps of ``config`` on ``device`` from the seed's weights (drawn
    on the CPU) with the given rows and draws (gaussian noise, or the beta
    prior's gamma pairs), the unfused Adam's rounding bits injected when
    given; step 1's gradients (as the optimizer received them) and
    weights, both steps' losses, on the CPU; on the CPU also the gamma
    draws it made when ``draws`` is None."""
    from scrubvae_torch import bench, factory
    from scrubvae_torch.data.dataset import StreamDataset
    from scrubvae_torch.data.pipeline import build_frame_store
    from scrubvae_torch.data.skeleton import load_skeleton
    from scrubvae_torch.data.synthetic import synthetic_pose_stream
    from scrubvae_torch.models import residual
    from scrubvae_torch.train.trainer import Trainer

    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    pose, ids = synthetic_pose_stream(skel, n_frames=4096, n_ids=4, seed=0)
    ds = StreamDataset(
        build_frame_store(pose, ids, skel, window=51, stride=2, device=device), skel, bench.KEYS, "midfwd",
        arena_size=bench.ARENA, discrete_classes={"ids": np.unique(ids)}, device=device,
    )
    model, info = factory.build_model(
        config["model"], config["disentangle"], 18, "midfwd", arena_size=bench.ARENA,
        discrete_classes=ds.discrete_classes, loss_keys=config["loss"].keys(), device=device,
    )
    trainer = Trainer(config, {"train": ds}, model, info, device=device)
    names = [n for n, _ in trainer.model.named_parameters()]

    def cpu(t):
        return t.detach().to("cpu", copy=True)

    out = {"losses": [], "draws": [], "w0": {n: cpu(p) for n, p in trainer.model.named_parameters()}}
    update = trainer.tx.update_and_apply

    def recording(grads, state, params, step=[0]):
        if step[0] == 0:
            out["grads"] = {n: cpu(g) for n, g in zip(names, grads)}
        kw = {} if bits is None else {"noise": [None if b is None else tuple(x.to(device) for x in b) for b in bits[step[0]]]}
        step[0] += 1
        return update(grads, state, params, **kw)

    trainer.tx.update_and_apply = recording
    gamma = residual.gamma_rsample
    for s in range(2):
        made = []

        def capture(alpha, generator=None, draw=None):
            z = gamma(alpha, generator, draw)
            made.append(cpu(z))
            return z

        residual.gamma_rsample = capture
        try:
            eps = None if draws is None else draws[s]
            if isinstance(eps, np.ndarray):
                eps = torch.from_numpy(eps).to(device)
            elif eps is not None:
                eps = tuple(e.to(device) for e in eps)
            trainer.state, metrics = trainer.train_step(
                trainer.state, torch.as_tensor(rows[s] % len(ds), device=device), trainer.loss_scale_for_epoch(1), eps=eps,
            )
        finally:
            residual.gamma_rsample = gamma
        out["draws"].append(tuple(made))
        out["losses"].append({k: float(v) for k, v in metrics.items()})
        if s == 0:
            out["w1"] = {n: cpu(p) for n, p in trainer.model.named_parameters()}
    return out


SURFACE_PARITY = {
    # label: (model overrides, train overrides, channels)
    "low_rank": ({"sigma_head_rank": 8}, {}, None),
    "beta_prior": ({"prior": "beta"}, {}, None),
    "sgd": ({}, {"optimizer": "sgd"}, None),
    # a last channel of 128: fc_sigma 512 x 136 keeps bf16 moments
    "unfused_adam": ({}, {"fused_optimizer": False, "moment_dtype": "bf16"}, [8, 8, 16, 16, 128]),
}


def surface_parity(label: str) -> dict:
    """Steps 1 and 2 on the card against the CPU at z 16, window 51, f32,
    batch 16, without clip, the same rows and noise on both sides (the beta
    prior's gamma draws made on the CPU and injected on the card; the
    unfused Adam's rounding bits drawn on the host and injected on both):
    losses 1e-4 at step 1 and 1e-2 at step 2, gradients as
    ``parity.check_grads``, weights as ``parity.check_weights`` at four
    ulps (the Adam steps), but for the unfused Adam's bf16-moment leaf
    within 2^-6 lr outside the gradient's noise band (its moments round the
    same bits from inputs 1e-3 apart); for sgd each side's step 1 is
    w0 - lr (g + 0.2 g) of its own gradient to an ulp."""
    from scrubvae_torch import bench
    from scrubvae_torch.train import parity

    model, train, ch = SURFACE_PARITY[label]
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_surface_parity_"))
    try:
        config = _models_config(tmp, 16, 16, ch or bench.SMALL_CH, False, model=model, precision="fp32", **train)
        rng = np.random.default_rng(11)
        rows = rng.integers(0, 1 << 20, (2, 16))
        draws = None if label == "beta_prior" else [rng.standard_normal((16, 16)).astype(np.float32) for _ in range(2)]
        bits = None
        if label == "unfused_adam":
            from scrubvae_torch import factory
            from scrubvae_torch.train import optim

            m, _ = factory.build_model(config["model"], config["disentangle"], 18, "midfwd", arena_size=bench.ARENA,
                                       loss_keys=config["loss"].keys(), device="cpu")
            shapes = [tuple(p.shape) for p in m.parameters()]
            bits = [[tuple(torch.from_numpy(rng.integers(0, 1 << 16, s)) for _ in range(2))
                     if math.prod(s) >= optim.FusedAdamW.MIN_LOWP_ELEMS else None for s in shapes] for _ in range(2)]
        cpu = _surface_parity_run("cpu", config, rows, draws, bits)
        if draws is None:
            draws = cpu["draws"]
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True)
        try:
            card = _surface_parity_run(DEVICE, config, rows, draws, bits)
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"run": label, "bf16_leaves": 0 if bits is None else sum(b is not None for b in bits[0])}
    rec["max_loss_rel_step1"] = parity.check_losses(cpu["losses"][0], card["losses"][0], 1e-4)
    rec.update(parity.check_grads(cpu["grads"], card["grads"]))
    if label == "sgd":
        # each side's step 1 is w0 - lr (g + 0.2 g) of its own gradient, to
        # an ulp of the larger of w0 and the step; the gradients are held above
        worst = 0.0
        for side in (cpu, card):
            for n, w in side["w1"].items():
                g = side["grads"][n]
                step = parity.LR * (g + 0.2 * g)
                want = side["w0"][n] - step
                d = (w - want).abs()
                if bool((d > 2.0**-23 * (side["w0"][n].abs() + step.abs())).any()):
                    raise AssertionError(f"sgd: step 1 of {n} is not w0 - 1.2 lr g, by up to {float(d.max()):.3e}")
                worst = max(worst, float(d.max()))
        rec["max_step_abs"] = worst
    else:
        # a bf16-moment leaf: the same bits round moments whose inputs
        # differ at the gradients' 1e-3, so a moment may land one bf16 ulp
        # (2^-8) apart and m / sqrt(n) two; the step 1 update is lr times
        # that ratio, so 2^-6 lr, outside the noise band of the gradient
        lowp = set() if bits is None else {n for n, b in zip(cpu["w1"], bits[0]) if b is not None}
        keep = {n: w for n, w in cpu["w1"].items() if n not in lowp}
        rec.update(parity.check_weights(keep, {n: card["w1"][n] for n in keep}, cpu["grads"], ulps=4,
                                        got_grads=card["grads"]))
        for n in lowp:
            w, g = cpu["w1"][n], cpu["grads"][n]
            d = (card["w1"][n] - w).abs()
            band = g.abs() < 5e-2 * torch.sqrt(torch.mean(g * g))
            out_ = (d > 2.0**-6 * parity.LR + 4 * 2.0**-23 * w.abs()) & ~band
            rec[f"rounding_apart {n}"] = int((d > 4 * 2.0**-23 * (w.abs() + parity.LR)).sum())
            rec[f"max_update_apart_over_lr {n}"] = float(d[~band].max()) / parity.LR
            if bool(out_.any()):
                raise AssertionError(
                    f"unfused adam: {int(out_.sum())} of {w.numel()} weights of {n} differ after step 1 by more "
                    f"than 2^-6 lr, up to {float(d[out_].max()):.3e}"
                )
    rec["max_loss_rel_step2"] = parity.check_losses(cpu["losses"][1], card["losses"][1], 1e-2)
    log(f"surface {label} card against CPU, steps 1 and 2: " + json.dumps(rec))
    return rec


def surface_phase(card: str) -> dict:
    """The rest of the training config surface (see the module docstring)."""
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_surface_"))
    try:
        t0 = time.perf_counter()
        parity_recs = {label: surface_parity(label) for label in SURFACE_PARITY}
        out = {"card_vs_cpu": parity_recs}
        out["parkinsons"] = parkinsons_runs(card, tmp)
        out["host_stream"] = host_stream_runs(card, tmp)
        out["optimizers_prior"] = optimizer_prior_runs(card, tmp)
        out["bench"] = surface_bench()
        out["phase_s"] = time.perf_counter() - t0
        log(f"surface phase: {out['phase_s']:.1f} s")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 13: offline analysis
# ---------------------------------------------------------------------------

ANALYSIS_EPOCHS = (15, 20)
# the fit phase's val split (4 ids x 2600 frames) tenfold: 51,900 windows
ANALYSIS_VAL_FRAMES = 26000
ANALYSIS_Z_DIM = 128
ANALYSIS_COMPONENTS = 25
ANALYSIS_MIN_SAMPLES = 500
# card against CPU: float64 GMM on this many latents (2,048 to 5,120), the
# parameters within GMM_CARD_CPU_RTOL of the largest entry (EM on the two
# devices differs by the order of float64 sums, about 1e-14)
GMM_CPU_ROWS = 5120
GMM_CARD_CPU_RTOL = 1e-8
# card against CPU in float32 on the same latents: EM for GMM_F32_ITERS
# iterations, fewer than the 16 to 21 float64 EM takes there, so that
# neither device stops at sklearn's tol on a rounding difference; weights,
# means and covariances within the CPU tests' float32 bound of the largest
# entry (tests/test_torch_port_cluster.py); labels differing on at most
# GMM_F32_LABELS rows (0.1%: a label moves only where two components'
# float32 log-likelihoods tie within rounding). The precision factors are
# the inverse Cholesky factors of covariances whose condition number
# reaches 1.5e7 on these latents, so their float32 error scales with it:
# each device's are held against float64 factors of its own covariances
# within kappa * eps(float32) of the component's largest entry (the
# first-order bound for an inverse; on an H100 80GB HBM3 at 700 W the
# card's reached 0.078 of it, the host CPU's 0.016)
GMM_F32_ITERS = 10
GMM_F32_RTOL = 1e-4
GMM_F32_LABELS = 5
# the full-size float32 GMM against a float64 E-step on the host with its
# own fitted parameters: labels differing on at most 0.1% of the rows, the
# mean log-likelihood within sklearn's tol (EM's own resolution of it), and
# EM's ascent: the last M-step's parameters score at least the last lower
# bound, less that tol
GMM_FULL_LABEL_SHARE = 1e-3
GMM_LOGLIK_TOL = 1e-3
# HDBSCAN card against CPU: 5 planted 128-d blobs of 1,024 points at
# min_samples 500, and this many latents at min_samples 50
HDBSCAN_BLOBS = (5, 1024)
HDBSCAN_CPU_ROWS = 5120
HDBSCAN_CPU_MIN_SAMPLES = 50
# traversal card against CPU, f32 with TF32 off: the bound the CPU tests
# hold the port to JAX with (tests/test_torch_port_traverse.py), one f32
# decoder pass and an 18-joint FK chain, relative to the largest coordinate
TRAVERSE_SHIFTS = 15
TRAVERSE_INDEX = 1000
TRAVERSE_CARD_CPU_TOL = 1e-4


def _analysis_weights(run: pathlib.Path) -> dict:
    """The fit phase's config trained to epoch 20 with decodability off
    (``train.minimal_test``), into ``run``: weights at 15 and 20."""
    from scrubvae_torch import bench, factory
    from scrubvae_torch.train import trainer as trainer_mod

    datasets = _fit_splits()
    config = _fit_config(run, model={"start_epoch": FIT_START}, minimal_test=True)
    model, info = factory.build_model(
        config["model"], config["disentangle"], n_keypts=18, direction_process="midfwd",
        arena_size=bench.ARENA, discrete_classes=datasets["train"].discrete_classes,
        loss_keys=config["loss"].keys(), device=DEVICE,
    )
    _reset_launches()
    t0 = time.perf_counter()
    trainer = trainer_mod.train(config, datasets, model, info, device=DEVICE)
    torch.cuda.synchronize()
    launches = _launches()
    steps = trainer.steps_per_epoch * (FIT_EPOCHS - FIT_START)
    if launches != 2 * steps:
        raise AssertionError(f"analysis: {launches} optimizer launches in {steps} steps; expected 2 a step")
    if list(factory.all_saved_epochs(run)) != list(ANALYSIS_EPOCHS):
        raise AssertionError(f"analysis: weights at {factory.all_saved_epochs(run)}")
    return {"train_s": time.perf_counter() - t0, "steps": steps, "optimizer_launches": launches}


def _timed(fn, *a, **k):
    """(result, seconds) of ``fn``, between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*a, **k)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def gmm_card_vs_cpu(z: np.ndarray, dtype) -> dict:
    """The GMM (25 components, full) on ``GMM_CPU_ROWS`` latents in
    ``dtype`` on the card and on the CPU from the same ``np.random.seed``:
    the same k-means++ centres and ``n_iter_``. In float64, 150 iterations
    at most, identical labels and the parameters within
    ``GMM_CARD_CPU_RTOL``; in float32, ``GMM_F32_ITERS`` iterations, the
    bounds stated at ``GMM_F32_ITERS``."""
    from scrubvae_torch.evals import cluster

    x = z[np.random.RandomState(5).choice(len(z), GMM_CPU_ROWS, replace=False)].astype(dtype)
    f32 = dtype == np.float32
    picks = {d: cluster.kmeans_plusplus(torch.as_tensor(x, device=d), ANALYSIS_COMPONENTS, np.random.RandomState(6))
             for d in (DEVICE, "cpu")}
    fits, secs = {}, {}
    for d in (DEVICE, "cpu"):
        np.random.seed(6)
        gm = cluster.GaussianMixture(ANALYSIS_COMPONENTS, "full", max_iter=GMM_F32_ITERS if f32 else 150,
                                     reg_covar=1e-5)
        with warnings.catch_warnings():
            # float32 stops at GMM_F32_ITERS on purpose
            warnings.simplefilter("ignore", cluster.ConvergenceWarning)
            fits[d], secs[d] = _timed(gm.fit, x, device=d)
    card, cpu = fits[DEVICE], fits["cpu"]
    rec = {
        "dtype": np.dtype(dtype).name, "rows": len(x), "kmeans_pp_equal": bool((picks[DEVICE] == picks["cpu"]).all()),
        "n_iter": [card.n_iter_, cpu.n_iter_], "converged": [card.converged_, cpu.converged_],
        "lower_bound": [card.lower_bound_, cpu.lower_bound_],
        "labels_differing": int((card.predict(x, device=DEVICE) != cpu.predict(x, device="cpu")).sum()),
        **{f"{name}_rel": _rel(getattr(card, f"{name}_"), getattr(cpu, f"{name}_"))
           for name in ("weights", "means", "covariances")},
        "card_s": secs[DEVICE], "cpu_s": secs["cpu"],
    }
    rtol, labels_ok = (GMM_F32_RTOL, GMM_F32_LABELS) if f32 else (GMM_CARD_CPU_RTOL, 0)
    ok = rec["kmeans_pp_equal"] and card.n_iter_ == cpu.n_iter_ and rec["labels_differing"] <= labels_ok and all(
        rec[f"{name}_rel"] <= rtol for name in ("weights", "means", "covariances")
    )
    if f32:
        # each device's precision factors against float64 factors of its own
        # covariances, component by component, over kappa * eps(float32)
        share, kappa = {}, {}
        for d, gm in ((DEVICE, card), ("cpu", cpu)):
            cov = gm.covariances_.astype(np.float64)
            want = cluster._compute_precision_cholesky(torch.as_tensor(cov), "full").numpy()
            err = np.abs(gm.precisions_cholesky_ - want).max(axis=(1, 2)) / np.abs(want).max(axis=(1, 2))
            kappa[d] = np.linalg.cond(cov)
            share[d] = float((err / (kappa[d] * np.finfo(np.float32).eps)).max())
        rec["precisions_cholesky_rel"] = _rel(card.precisions_cholesky_, cpu.precisions_cholesky_)
        rec["covariance_kappa_max"] = float(kappa[DEVICE].max())
        rec["precisions_cholesky_share_of_bound"] = [share[DEVICE], share["cpu"]]
        ok = ok and max(share.values()) <= 1.0
    if not ok:
        raise AssertionError(f"analysis: GMM card against CPU: {rec}")
    return rec


def gmm_against_float64(gm, z: np.ndarray, labels: np.ndarray) -> dict:
    """The full-size float32 GMM ``gm`` and its ``labels`` on the card
    against a float64 E-step on the host with ``gm``'s own parameters: the
    labels differing on at most ``GMM_FULL_LABEL_SHARE`` of the rows; the
    mean log-likelihood on the card within ``GMM_LOGLIK_TOL`` of the
    host's; and that value at least ``gm.lower_bound_`` less
    ``GMM_LOGLIK_TOL`` (EM's ascent through the last M-step)."""
    from scrubvae_torch.evals import cluster

    def e_step(x: torch.Tensor, logsumexp):
        params = [torch.as_tensor(p).to(device=x.device, dtype=x.dtype)
                  for p in (gm.weights_, gm.means_, gm.precisions_cholesky_)]
        weighted = gm._weighted_log_prob(x, *params)
        return weighted.argmax(1).cpu().numpy(), float(logsumexp(weighted).mean())

    # the host's log-sum-exp is torch's own, not the port's
    card_labels, card_ll = e_step(torch.as_tensor(z, device=DEVICE), cluster._logsumexp)
    host_labels, host_ll = e_step(torch.as_tensor(z, dtype=torch.float64), lambda w: torch.logsumexp(w, dim=1))
    rec = {
        "labels_differing_from_float64": int((labels != host_labels).sum()),
        "predict_equals_card_estep": bool((labels == card_labels).all()),
        "loglik_card_f32": card_ll, "loglik_host_f64": host_ll, "lower_bound": gm.lower_bound_,
    }
    if not (rec["predict_equals_card_estep"]
            and rec["labels_differing_from_float64"] <= GMM_FULL_LABEL_SHARE * len(z)
            and abs(card_ll - host_ll) <= GMM_LOGLIK_TOL and host_ll >= gm.lower_bound_ - GMM_LOGLIK_TOL):
        raise AssertionError(f"analysis: the float32 GMM against a float64 E-step: {rec}")
    return rec


def hdbscan_card_vs_cpu(z: np.ndarray) -> dict:
    """HDBSCAN labels on the card and on the CPU, identical on planted
    blobs (each recovered) and on a subset of the latents."""
    from scrubvae_torch.evals import cluster

    n_blobs, per = HDBSCAN_BLOBS
    rng = np.random.default_rng(9)
    blobs = np.concatenate([rng.normal(size=(per, ANALYSIS_Z_DIM)) + rng.normal(size=ANALYSIS_Z_DIM) * 3
                            for _ in range(n_blobs)])
    sub = z[np.random.RandomState(10).choice(len(z), HDBSCAN_CPU_ROWS, replace=False)]
    rec, card_labels = {}, {}
    for name, x, k in (("blobs", blobs, ANALYSIS_MIN_SAMPLES), ("latents", sub, HDBSCAN_CPU_MIN_SAMPLES)):
        (card, card_s), (cpu, cpu_s) = (_timed(cluster.hdbscan, x, min_cluster_size=k, device=d) for d in (DEVICE, "cpu"))
        card_labels[name] = card
        rec[name] = {
            "rows": len(x), "min_samples": k, "labels_differing": int((card != cpu).sum()),
            "clusters": int(card.max() + 1), "noise": int((card == -1).sum()), "card_s": card_s, "cpu_s": cpu_s,
        }
        if rec[name]["labels_differing"]:
            raise AssertionError(f"analysis: HDBSCAN card against CPU on {name}: {rec[name]}")
    # the core distances and the MST's edges themselves, bitwise (the card
    # replays captured graphs, the CPU steps eagerly), on 1,024 latents
    x = torch.as_tensor(sub[:1024], dtype=torch.float64)
    parts = {}
    for d in (DEVICE, "cpu"):
        core = cluster._core_sq(x.to(d), HDBSCAN_CPU_MIN_SAMPLES)
        parts[d] = [core.cpu().numpy(), *cluster._prim_mst(x.to(d), core)]
    rec["core_and_mst_bitwise"] = all(np.array_equal(a, b) for a, b in zip(parts[DEVICE], parts["cpu"]))
    if not rec["core_and_mst_bitwise"]:
        raise AssertionError("analysis: HDBSCAN core distances or MST edges differ between the card and the CPU")
    # each blob recovered: nine tenths of it in a cluster of its own
    owners = []
    for b in np.split(card_labels["blobs"], n_blobs):
        owners.append(np.bincount(b[b >= 0]).argmax() if (b >= 0).any() else -1)
        if owners[-1] < 0 or (b == owners[-1]).mean() < 0.9:
            raise AssertionError(f"analysis: a planted blob was not recovered: {np.unique(b, return_counts=True)}")
    if len(set(owners)) != n_blobs:
        raise AssertionError(f"analysis: the planted blobs share clusters: {owners}")
    return rec


def traverse_card_vs_cpu(run: pathlib.Path, config: dict, val_card, val_cpu, z: np.ndarray) -> dict:
    """``traverse_latent`` with 15 shifts, graded and circle, rendering off,
    of the epoch-20 weights at full width in f32 on the card and on the
    CPU; the poses within ``TRAVERSE_CARD_CPU_TOL``."""
    from scrubvae_torch import factory
    from scrubvae_torch.evals.traverse import traverse_latent
    from scrubvae_torch.utils import checkpoint as ckpt

    models = {}
    for d, ds in ((DEVICE, val_card), ("cpu", val_cpu)):
        models[d], _ = factory.build_model(
            dict(config["model"], precision="fp32"), config["disentangle"], n_keypts=ds.n_keypts,
            direction_process="midfwd", arena_size=ds.arena_size, discrete_classes=ds.discrete_classes, device=d,
        )
        ckpt.load_weights(run, ANALYSIS_EPOCHS[-1], models[d])
    weights = {
        "graded": models["cpu"].linear["avg_speed_3d"].weight.detach().numpy(),
        "circle": np.random.RandomState(3).normal(size=(2, z.shape[1])).astype(np.float32),
    }
    rec = {}
    for name, w in weights.items():
        kw = dict(index=TRAVERSE_INDEX, n_shifts=TRAVERSE_SHIFTS, circle=name == "circle",
                  grid_vis=False, arena_vis=False, static_vis=False)
        (card, card_s), (cpu, cpu_s) = (_timed(traverse_latent, models[d], ds, z, w, **kw)
                                        for d, ds in ((DEVICE, val_card), ("cpu", val_cpu)))
        rec[name] = {"shape": list(card.shape), "rel_err": _rel(card, cpu), "card_s": card_s, "cpu_s": cpu_s}
        if card.shape != (TRAVERSE_SHIFTS * 51, 18, 3) or not np.isfinite(card).all() or not (
            rec[name]["rel_err"] <= TRAVERSE_CARD_CPU_TOL
        ):
            raise AssertionError(f"analysis: traversal {name}, card against CPU: {rec[name]}")
    return rec


def profiling_checks() -> dict:
    """``trace`` writes a Chrome trace under ``build/`` with device events,
    ``device_memory_stats`` names the card, ``debug_nans`` raises on a NaN
    planted in the forward and in the backward pass and not once it is
    off."""
    from scrubvae_torch.utils import profiling

    with profiling.trace(str(ROOT / "build" / "analysis_trace")) as path:
        a = torch.randn(512, 512, device=DEVICE)
        (a @ a).sum().item()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    stats = profiling.device_memory_stats()
    name = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    if not pathlib.Path(path).is_file() or (torch.cuda.is_available() and (
        kernels == 0 or not any(name in k for k in stats)
    )):
        raise AssertionError(f"analysis: trace {path} with {kernels} kernel events, memory stats of {list(stats)}")
    raised = {}
    x = torch.tensor([1.0, 0.0], device=DEVICE)
    w = torch.tensor([0.0, 4.0], device=DEVICE, requires_grad=True)
    mask = torch.tensor([0.0, 1.0], device=DEVICE)
    for part in ("forward", "backward"):
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                with profiling.debug_nans():
                    if part == "forward":
                        (torch.log(x) - torch.log(x)).sum().item()
                    else:
                        (torch.sqrt(w) * mask).sum().backward()
        except (FloatingPointError, RuntimeError) as e:
            raised[part] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    w.grad = None
    (torch.sqrt(w) * mask).sum().backward()  # off: the NaN goes through
    quiet = bool(torch.isnan(w.grad[0])) and not torch.is_anomaly_enabled()
    if "FloatingPointError" not in raised.get("forward", "") or "backward" not in raised or not quiet:
        raise AssertionError(f"analysis: debug_nans raised {raised}, quiet when off: {quiet}")
    return {"trace": str(pathlib.Path(path).relative_to(ROOT)), "trace_kernel_events": kernels,
            "memory_stats_devices": list(stats), "debug_nans_raised": raised}


def analysis_phase(card: str, tmp: pathlib.Path) -> dict:
    """Latents, GMM, cluster entropy, HDBSCAN and traversal at full flagship
    width on the fit phase's weights (see the module docstring)."""
    import yaml

    from scrubvae_torch import factory
    from scrubvae_torch.data.skeleton import load_skeleton
    from scrubvae_torch.data.synthetic import synthetic_pose_stream
    from scrubvae_torch.evals import cluster
    from scrubvae_torch.evals import metrics as em
    from scrubvae_torch.evals.latents import latents
    from scrubvae_torch.params import read

    t_phase = time.perf_counter()
    rec = {"card": card}
    run = tmp / "fit_run"
    if not run.is_dir():
        rec["training"] = _analysis_weights(run)
    # the val split tenfold; the card's machine has no h5py, so the pose
    # file is a placeholder and factory.read_pose_h5 serves it from memory
    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    arrays = synthetic_pose_stream(skel, n_frames=ANALYSIS_VAL_FRAMES * 4, n_ids=4, seed=1)
    data = tmp / "data"
    (data / "synthetic" / "val").mkdir(parents=True)
    (data / "synthetic" / "val" / "pose.h5").touch()
    shutil.copy(ROOT / "configs" / "mouse_skeleton.yaml", data / "mouse_skeleton.yaml")
    cfg = yaml.safe_load((run / "model_config.yaml").read_text())
    # the config reader wrote the folder's path it was read in; the fit
    # phase's folder has moved since
    cfg["out_path"] = "current"
    cfg["data"]["data_path"] = str(data) + "/"
    (run / "model_config.yaml").write_text(yaml.safe_dump(cfg))
    config = read.config(run / "model_config.yaml", make_dirs=False)
    read_pose_h5 = factory.read_pose_h5
    timer = _Timer()
    try:
        factory.read_pose_h5 = lambda path: arrays
        # the keys the per-epoch harness loads, and the offsets the traversal's FK reads
        keys = ("x6d", "root", "avg_speed_3d", "heading", "offsets")
        val, rec["val_split_s"] = _timed(factory.mouse_data, config["data"], "val", data_keys=keys, window=51,
                                         device=DEVICE)
        z, rec["latents_s"] = {}, {}
        for e in ANALYSIS_EPOCHS:
            z[e], rec["latents_s"][e] = _timed(latents, config, epoch=e, dataset=val, label="val", device=DEVICE)
            if z[e].shape != (len(val), ANALYSIS_Z_DIM) or z[e].dtype != np.float32 or not np.isfinite(z[e]).all():
                raise AssertionError(f"analysis: epoch {e} latents {z[e].shape} {z[e].dtype}")
        rec["val_windows"] = len(val)

        # the GMM at its defaults on the float32 latents of epoch 15
        for owner, name, label in ((cluster, "kmeans_plusplus", "kmeans_pp"), (cluster.GaussianMixture, "fit", "em"),
                                   (cluster.GaussianMixture, "predict", "predict")):
            timer.wrap(owner, name, label)
        np.random.seed(0)
        (k15, gm), gmm_s = _timed(cluster.gmm, z[15], label="val_15", path=str(run) + "/", device=DEVICE)
        em_ms = timer.total_ms("em") - timer.total_ms("kmeans_pp")
        rec["gmm"] = {
            "total_s": gmm_s, "kmeans_pp_ms": timer.total_ms("kmeans_pp"), "em_ms": em_ms,
            "em_ms_per_iter": em_ms / max(gm.n_iter_, 1), "predict_ms": timer.total_ms("predict"),
            "n_iter": gm.n_iter_, "converged": gm.converged_, "lower_bound": gm.lower_bound_,
            "min_weight": float(gm.weights_.min()), "clusters_used": int(len(np.unique(k15))),
        }
        timer.undo()
        if not (gm.weights_ > 0).all() or gm.means_.dtype != np.float32 or len(gm.weights_) != ANALYSIS_COMPONENTS:
            raise AssertionError(f"analysis: GMM {rec['gmm']}")
        log(f"analysis GMM ({card}): " + json.dumps(rec["gmm"]))
        rec["gmm_against_float64"] = gmm_against_float64(gm, z[15], k15)
        log("analysis GMM, against a float64 E-step: " + json.dumps(rec["gmm_against_float64"]))
        rec["gmm_card_vs_cpu"] = [gmm_card_vs_cpu(z[20], dtype) for dtype in (np.float64, np.float32)]
        log("analysis GMM, card against CPU: " + json.dumps(rec["gmm_card_vs_cpu"]))

        # epoch 20 against epoch 15's cached clustering
        np.random.seed(1)
        ent, rec["entropy_s"] = _timed(
            em.epoch_cluster_entropy, str(run), "cluster_entropy", "val", save_load=False, start_epoch=15,
            comparison_clustering=str(run / "val_15_gmm.npy"), device=DEVICE,
        )
        rec["entropy"] = ent["Entropy"]
        if list(ent["epochs"]) != [20] or not all(
            math.isfinite(v) and 0.0 <= v <= math.log2(ANALYSIS_COMPONENTS) for v in ent["Entropy"]
        ):
            raise AssertionError(f"analysis: cluster entropy {ent}")

        # HDBSCAN at min_samples 500 on every latent of epoch 20
        tree_parts = ("_single_linkage", "_condense_tree", "_compute_stability", "_eom_labels")
        for name in ("_core_sq", "_prim_mst") + tree_parts:
            timer.wrap(cluster, name, name.strip("_"))
        labels, hdb_s = _timed(cluster.dbscan, z[20], min_samples=ANALYSIS_MIN_SAMPLES, label="val_20",
                               path=str(run) + "/", device=DEVICE)
        core_ms, mst_ms = timer.total_ms("core_sq"), timer.total_ms("prim_mst")
        tree_ms = sum(timer.total_ms(name.strip("_")) for name in tree_parts)
        timer.undo()
        # the MST's least time: each out-of-tree row of the 128 float64
        # features read once a step, n (n - 1) / 2 rows in all
        n = len(labels)
        rec["hdbscan"] = {
            "total_s": hdb_s, "core_distances_ms": core_ms, "mst_ms": mst_ms,
            "mst_bytes_bound_ms": n * (n - 1) / 2 * ANALYSIS_Z_DIM * 8 / HBM_BYTES_PER_S * 1e3,
            "tree_ms": tree_ms, "rest_ms": hdb_s * 1e3 - core_ms - mst_ms - tree_ms, "clusters": int(labels.max() + 1),
            "noise": int((labels == -1).sum()),
        }
        if labels.shape != (len(val),) or not (run / "val_20_sc_pred.npy").is_file():
            raise AssertionError(f"analysis: HDBSCAN labels {labels.shape}")
        log(f"analysis HDBSCAN ({card}): " + json.dumps(rec["hdbscan"]))
        rec["hdbscan_card_vs_cpu"] = hdbscan_card_vs_cpu(z[20])
        log("analysis HDBSCAN, card against CPU: " + json.dumps(rec["hdbscan_card_vs_cpu"]))

        val_cpu = factory.mouse_data(config["data"], "val", data_keys=keys, window=51, device="cpu")
        rec["traversal"] = traverse_card_vs_cpu(run, config, val, val_cpu, z[20])
    finally:
        timer.undo()
        factory.read_pose_h5 = read_pose_h5
    # in a process of its own: after the earlier phases' profiler sessions,
    # CUPTI once delivered no kernel record to a later session in the same
    # process, while a fresh process's trace holds them
    res = subprocess.run(
        [sys.executable, "-c", "import json, sys; sys.path.insert(0, '.'); import chip_smoke; "
         "print(json.dumps(chip_smoke.profiling_checks()))"], cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    if res.returncode != 0:
        raise AssertionError(f"analysis: profiling checks: {res.stdout[-2000:]} {res.stderr[-4000:]}")
    rec["profiling"] = json.loads(res.stdout.strip().splitlines()[-1])
    res = subprocess.run(
        [sys.executable, "-c", "import sys; sys.modules['matplotlib'] = None; import scrubvae_torch.plot, "
         "scrubvae_torch.evals"], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    if res.returncode != 0:
        raise AssertionError(f"analysis: the port's plot package needs matplotlib to import: {res.stderr}")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"analysis phase ({card}): " + json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# phase 14: serving
# ---------------------------------------------------------------------------

SERVE_BATCHES = (1, 8, 64, 512)
SERVE_ITERS = 20
SERVE_DEVICE_SESSIONS = 3
# an artifact against the eager model on one device: the CPU tests'
# tolerance (tests/test_torch_port_export.py), the root's atol through the
# arena's half-width. The bf16 trained run is held to it too: its artifacts
# run the eager model's aten calls, so they agree to the bit, while one
# that lost the bf16 casts would miss by about 2**-8
SERVE_TOL = (1e-4, 1e-5)
SERVE_STEPS = 3
SERVE_EPOCH = 5
SERVE_RUN_BATCH = 64


def _serve_err(label: str, got: dict, want: dict, tol) -> float:
    """Largest difference of ``got`` from ``want`` over its keys, each held
    to ``tol`` = (rtol, atol), the root's atol times 290."""
    if set(got) != set(want):
        raise AssertionError(f"{label}: outputs {sorted(got)}, eager {sorted(want)}")
    worst = 0.0
    for k, w in want.items():
        g, w = got[k].float().cpu().numpy(), w.float().cpu().numpy()
        atol = tol[1] * (290.0 if k == "root" else 1.0)
        np.testing.assert_allclose(g, w, rtol=tol[0], atol=atol, err_msg=f"{label} {k}")
        worst = max(worst, float(np.abs(g - w).max()))
    return worst


def _packed_forward(model, data: dict) -> dict:
    """The eval encoder's outputs (the packed head) and a train-mode
    forward's (the packed sampler) from fixed noise, with deterministic
    algorithms (the sampler's ``index_add`` is atomic otherwise); the
    BatchNorm statistics restored after it."""
    stats = {k: v.clone() for k, v in model.state_dict().items()}
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        with torch.no_grad():
            model.eval()
            enc = model.encode(data)
            model.train()
            out = model(data, eps=torch.ones(data["x6d"].shape[0], model.vae.z_dim, device=data["x6d"].device))
            model.eval()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    model.load_state_dict(stats)
    return {**{f"eval_{k}": v for k, v in enc.items()}, **{k: out[k] for k in ("z", "x6d", "root")}}


def _eager(model, data: dict, z: torch.Tensor, cond: dict) -> dict:
    with torch.no_grad():
        enc = model.encode(data)
        return {"encoder": enc, "encoder_mu": {"mu": enc["mu"]}, "decoder": model.decode(z, dict(cond))}


def _artifacts_vs_eager(label: str, fns: dict, model, shapes: dict, cond_shapes: dict, z_dim: int, tol,
                        batches=SERVE_BATCHES) -> dict:
    """Each artifact against the eager model at each batch size on random
    inputs; returns the largest difference by artifact."""
    from scrubvae_torch import serve_bench

    rng = np.random.default_rng(7)
    errs = {}
    for n in batches:
        data = serve_bench.poses(rng, n, shapes, DEVICE)
        z = serve_bench.normals(rng, n, {"z": (z_dim,)}, DEVICE)["z"]
        cond = serve_bench.normals(rng, n, cond_shapes, DEVICE)
        want = _eager(model, data, z, cond)
        with torch.no_grad():
            got = {"encoder": fns["encoder"](data), "encoder_mu": fns["encoder_mu"](data),
                   "decoder": fns["decoder"](z, cond)}
        for a in got:
            if any(v.shape[0] != n or v.device != data["x6d"].device for v in got[a].values()):
                raise AssertionError(f"{label} {a} at batch {n}: {[(v.shape, v.device) for v in got[a].values()]}")
            errs[a] = max(errs.get(a, 0.0), _serve_err(f"{label} {a} batch {n}", got[a], want[a], tol))
    return errs


def serve_flagship(card: str) -> dict:
    """The flagship in f32 exported on the card, its artifacts against the
    eager model, the mu-only size rule, the packed head after the exports,
    an artifact exported on the CPU run on the card, and the serve lines."""
    from scrubvae_torch import serve_bench
    from scrubvae_torch.models import layers
    from scrubvae_torch.utils.export import export_decoder, export_encoder, load_exported

    model, ex, info = serve_bench.flagship(DEVICE)
    cond_keys, z_dim = info["conditional_keys"], info["z_dim"]
    shapes = {k: tuple(ex[k].shape[1:]) for k in ("x6d", "root")}
    cond_shapes = {k: tuple(ex[k].shape[1:]) for k in cond_keys}
    probe = {k: v.repeat(8, *[1] * (v.dim() - 1)) for k, v in ex.items()}
    before = _packed_forward(model, probe)
    # an exporting process starts with empty index caches: the trace fills
    # them, as in `python -m scrubvae_torch.export_model`
    layers._tril_tensors.cache_clear()
    blobs, export_s = {}, {}
    for a, fn in (
        ("encoder", lambda: export_encoder(model, ex)),
        ("encoder_mu", lambda: export_encoder(model, ex, mu_only=True)),
        ("decoder", lambda: export_decoder(model, ex, z_dim, cond_keys)),
    ):
        blobs[a], export_s[a] = _timed(fn)
    after = _packed_forward(model, probe)
    changed = [k for k in before if type(after[k]) is not torch.Tensor or not bits_equal(after[k], before[k])]
    if changed:
        raise AssertionError(f"serve: the packed head's eager outputs changed after the exports: {changed}")
    sigma_bytes = sum(p.numel() * p.element_size() for n, p in model.named_parameters() if "fc_sigma" in n)
    shrink = len(blobs["encoder"]) - len(blobs["encoder_mu"])
    if shrink < 0.9 * sigma_bytes:
        raise AssertionError(f"serve: encoder_mu.pt2 only {shrink} bytes smaller; fc_sigma holds {sigma_bytes}")
    fns, load_s = {}, {}
    for a, blob in blobs.items():
        fns[a], load_s[a] = _timed(load_exported, blob)
    errs = _artifacts_vs_eager("flagship", fns, model, shapes, cond_shapes, z_dim, SERVE_TOL)

    # exported on the CPU (the same weights: init_weights draws on the host),
    # loaded onto the card
    cpu_model, cpu_ex, _ = serve_bench.flagship("cpu")
    (cpu_blob, cpu_export_s) = _timed(export_encoder, cpu_model, cpu_ex)
    del cpu_model
    moved, move_s = _timed(load_exported, cpu_blob, DEVICE)
    moved_errs = _artifacts_vs_eager(
        "cpu-exported encoder", {**fns, "encoder": moved}, model, shapes, cond_shapes, z_dim, SERVE_TOL,
        batches=(64,),
    )
    lines = serve_bench.bench(
        fns, shapes, cond_shapes, z_dim, SERVE_BATCHES, SERVE_ITERS, torch.device(DEVICE),
    )
    breakdown = _serve_breakdown(fns, model, shapes, cond_shapes, z_dim, lines)
    dev = {(r["artifact"], r["batch"]): r["device_ms"] for r in breakdown}
    mu_only = [
        {"batch": n, "encoder_device_ms": dev[("encoder", n)], "encoder_mu_device_ms": dev[("encoder_mu", n)],
         "saving_ms": dev[("encoder", n)] - dev[("encoder_mu", n)],
         "saving_share": 1.0 - dev[("encoder_mu", n)] / dev[("encoder", n)]}
        for n in SERVE_BATCHES
    ]
    rec = {
        "card": card, "bytes": {a: len(b) for a, b in blobs.items()}, "fc_sigma_bytes": sigma_bytes,
        "mu_only_shrink": shrink, "export_s": export_s, "load_s": load_s, "max_abs_err": errs,
        "cpu_export_s": cpu_export_s, "cpu_to_card_load_s": move_s, "cpu_exported_err": moved_errs["encoder"],
        "eager_unchanged_after_export": sorted(before), "breakdown": breakdown, "mu_only_on_device": mu_only,
    }
    log("serve flagship: " + json.dumps(rec))
    return {**rec, "lines": lines}


def _serve_breakdown(fns: dict, model, shapes: dict, cond_shapes: dict, z_dim: int, lines: list) -> list:
    """For each artifact and batch: the device time of a call (every kernel
    it launches, torch.profiler; the median of ``SERVE_DEVICE_SESSIONS``
    sessions of 10 calls, and the least and most), the device's idle share
    of the serve line's pipelined latency, and the eager model's pipelined
    latency on the same inputs, with its spread."""
    from scrubvae_torch import serve_bench

    rng = np.random.default_rng(3)
    latency = {(r["artifact"], r["batch"]): r["latency_ms"] for r in lines}
    out = []
    for n in SERVE_BATCHES:
        data = serve_bench.poses(rng, n, shapes, DEVICE)
        z = serve_bench.normals(rng, n, {"z": (z_dim,)}, DEVICE)["z"]
        cond = serve_bench.normals(rng, n, cond_shapes, DEVICE)
        calls = {
            "encoder": (lambda: fns["encoder"](data), lambda: model.encode(data)),
            "encoder_mu": (lambda: fns["encoder_mu"](data), lambda: model.encode(data, mu_only=True)),
            "decoder": (lambda: fns["decoder"](z, cond), lambda: model.decode(z, dict(cond))),
        }
        for a, (artifact, eager) in calls.items():
            with torch.no_grad():
                dev = sorted(device_ms(artifact, iters=10) for _ in range(SERVE_DEVICE_SESSIONS))
                st = serve_bench.time_call(eager, (), torch.device(DEVICE), SERVE_ITERS)
            med = dev[len(dev) // 2]
            out.append({
                "artifact": a, "batch": n, "device_ms": med, "device_ms_min": dev[0], "device_ms_max": dev[-1],
                "idle_share": 1.0 - med / latency[(a, n)], "eager_latency_ms": st["pipelined"] * 1e3,
                "eager_latency_ms_min": st["pipelined_min"] * 1e3, "eager_latency_ms_max": st["pipelined_max"] * 1e3,
            })
    return out


def serve_trained_run(card: str) -> dict:
    """A run the port trained (a few flagship steps through ``Trainer``,
    weights saved) through ``export_model``, ``serve_bench --run`` and
    ``export_torch``, its reference ``.pth`` imported back bit for bit. The
    card's machine has no ``h5py``: the split's pose file is a placeholder
    and ``factory.read_pose_h5`` serves its arrays from memory."""
    import yaml

    from scrubvae_torch import bench, export_model, export_torch, factory, serve_bench
    from scrubvae_torch.data.skeleton import load_skeleton
    from scrubvae_torch.data.synthetic import synthetic_pose_stream
    from scrubvae_torch.params import read
    from scrubvae_torch.train.trainer import Trainer
    from scrubvae_torch.utils import checkpoint as ckpt
    from scrubvae_torch.utils.export import load_exported
    from scrubvae_torch.utils.torch_import import import_torch_weights

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    read_pose_h5 = factory.read_pose_h5
    try:
        data = tmp / "data"
        (data / "synthetic" / "train").mkdir(parents=True)
        (data / "synthetic" / "train" / "pose.h5").touch()
        shutil.copy(ROOT / "configs" / "mouse_skeleton.yaml", data / "mouse_skeleton.yaml")
        skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
        arrays = synthetic_pose_stream(skel, n_frames=4 * 1200, n_ids=4, seed=0)
        factory.read_pose_h5 = lambda path: arrays
        run = tmp / "run"
        cfg = bench.bench_config(512, 51, 128, bench.FULL_CH, True)
        cfg["data"]["data_path"] = str(data) + "/"
        run.mkdir()
        (run / "model_config.yaml").write_text(yaml.safe_dump(dict(cfg, out_path="current")))
        cfg = read.config(run / "model_config.yaml")
        datasets, model, info = factory.data_and_model(
            cfg, train_val_test=("train",), data_keys=bench.KEYS, device=DEVICE
        )
        trainer = Trainer(cfg, datasets, model, info, device=DEVICE)
        rows = np.random.default_rng(0).integers(0, len(datasets["train"]), size=(SERVE_STEPS, 512))
        _reset_launches()
        torch.cuda.synchronize()
        metrics, train_s = _timed(trainer.train_epoch, 1, rows)
        launches = _launches()
        per_step = len(trainer.state.opt_state.table.batches)
        if not math.isfinite(metrics["total"]) or launches != per_step * SERVE_STEPS:
            raise AssertionError(f"serve run: total {metrics['total']}, {launches} launches in {SERVE_STEPS} steps")
        ckpt.save_weights(cfg["out_path"], SERVE_EPOCH, model)

        _reset_launches()
        out_dir, export_s = _timed(export_model.main, ["--run", str(run), "--device", DEVICE])
        factory.read_pose_h5 = read_pose_h5
        meta = json.loads((out_dir / "meta.json").read_text())
        fns = {a: load_exported(out_dir / f"{a}.pt2", DEVICE) for a in ("encoder", "encoder_mu", "decoder")}
        model.eval()
        errs = _artifacts_vs_eager(
            "trained run", fns, model, meta["input_shapes"], meta["conditional_shapes"], meta["z_dim"],
            SERVE_TOL, batches=(SERVE_RUN_BATCH,),
        )
        lines = serve_bench.main([
            "--run", str(run), "--batches", *map(str, SERVE_BATCHES), "--iters", str(SERVE_ITERS),
            "--device", DEVICE,
        ])
        serving_launches = _launches()
        if serving_launches:
            raise AssertionError(f"serve: {serving_launches} optimizer launches while exporting and serving")

        pth, pth_s = _timed(export_torch.main, ["--run", str(run), "--epoch", str(SERVE_EPOCH)])
        fresh, _ = factory.build_model(
            cfg["model"], cfg["disentangle"], n_keypts=18, direction_process="midfwd", arena_size=bench.ARENA,
            discrete_classes=datasets["train"].discrete_classes, loss_keys=cfg["loss"].keys(), device=DEVICE,
        )
        report = import_torch_weights(pth, fresh)
        if report != ([], []):
            raise AssertionError(f"serve: the reference .pth round trip left {report}")
        trained = model.state_dict()
        diff = [
            k for k, v in fresh.state_dict().items()
            if (int(v) != 0 if k.endswith("num_batches_tracked") else not bits_equal(v, trained[k].float()))
        ]
        if diff:
            raise AssertionError(f"serve: the reference .pth round trip changed {diff[:8]}")
        rec = {
            "card": card, "steps": SERVE_STEPS, "train_s": train_s, "optimizer_launches": launches,
            "launches_per_step": launches / SERVE_STEPS, "serving_launches": serving_launches,
            "export_model_s": export_s, "max_abs_err": errs, "pth_s": pth_s,
            "pth_bytes": pathlib.Path(pth).stat().st_size, "meta": meta,
            "bf16_leaves": sum(p.dtype == torch.bfloat16 for p in model.parameters()),
        }
        log("serve trained run: " + json.dumps(rec))
        return {**rec, "lines": lines}
    finally:
        factory.read_pose_h5 = read_pose_h5
        shutil.rmtree(tmp, ignore_errors=True)


def serve_phase(card: str) -> dict:
    """The serving path (see the module docstring)."""
    t0 = time.perf_counter()
    flagship = serve_flagship(card)
    torch.cuda.empty_cache()
    run = serve_trained_run(card)
    rec = {"flagship": flagship, "trained_run": run, "phase_s": time.perf_counter() - t0}
    log(f"serve phase: {rec['phase_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 15: train.mesh, ranks sharing the one card over gloo
# ---------------------------------------------------------------------------

# (label, train.mesh, ranks)
MESH_SPECS = (
    ("data2", {"data": 2}, 2),
    ("model2", {"data": 1, "model": 2}, 2),
    ("data2_model2", {"data": 2, "model": 2}, 4),
)
# warm-up and timed bf16 flagship steps a mesh; the 4-rank mesh takes fewer
MESH_STEPS = {"data2": (3, 5), "model2": (3, 5), "data2_model2": (1, 3)}
MESH_DIMS = {"batch": 512, "z": 128, "ch": None, "device": "cuda:0"}  # ch None: bench.FULL_CH
MESH_FC_SIGMA = "vae.encoder.fc_sigma.0.weight"


def _mesh_build(dims: dict, spec, parity: bool):
    """The flagship trainer of ``bench.build`` at ``dims`` under ``spec``:
    with ``parity`` in f32 (compute, storage and moments, so the step-1
    gradients read from the first moment are exact), else bf16 as the
    path phase runs it."""
    from scrubvae_torch import bench
    from scrubvae_torch.parallel import mesh as pmesh

    ch = dims["ch"] or bench.FULL_CH
    if not parity:
        return bench.build(dims["batch"], 51, dims["z"], ch, dims["device"], mesh=spec)
    trainer, ds = bench.build(dims["batch"], 51, dims["z"], ch, dims["device"], precision="fp32",
                              bf16_params=False, mesh=spec)
    trainer.tx.m_dtype = torch.float32
    trainer.state = trainer.state.replace(opt_state=trainer.tx.init(
        list(trainer.model.parameters()), shards=pmesh.leaf_shards(trainer.model),
        group=trainer.mesh.model_group if trainer.mesh is not None else None,
    ))
    return trainer, ds


def _mesh_inputs(dims: dict, n: int) -> tuple:
    rows = np.random.default_rng(0).integers(0, n, dims["batch"])
    eps = np.random.default_rng(1).standard_normal((dims["batch"], dims["z"])).astype(np.float32)
    return rows, eps


def _mesh_one_step(trainer, rows: np.ndarray, eps: np.ndarray) -> dict:
    """One train step on this rank's rows of ``rows`` with the global noise
    ``eps``: the losses, the step-1 gradients (m = (1 - b1) g) and weights
    (split leaves whole, gathered over the model group) as copies on the
    trainer's device, the MALS state on the host."""
    from scrubvae_torch.parallel import mesh as pmesh
    from scrubvae_torch.train.parity import MALS_KEYS

    dev = trainer.device
    local = pmesh.shard_batch(trainer.mesh, rows)
    trainer.state, metrics = trainer.train_step(
        trainer.state, torch.as_tensor(local, device=dev), trainer.loss_scale_for_epoch(1),
        eps=torch.from_numpy(eps).to(dev),
    )
    names = [n for n, _ in trainer.model.named_parameters()]
    splits = pmesh.split_of(trainer.model)
    b1 = trainer.tx.b1
    mals = trainer.state.scrub_state["moving_avg_lsq"]["avg_speed_3d"]
    return {
        "losses": {k: float(v) for k, v in metrics.items()},
        "grads": {n: pmesh.whole_leaf(m, c) / (1.0 - b1) for n, m, c in zip(names, trainer.state.opt_state.mu, splits)},
        "w1": {n: pmesh.whole_leaf(p.detach(), c).clone() for (n, p), c in zip(trainer.model.named_parameters(), splits)},
        "mals": {k: getattr(mals, k).to("cpu", copy=True) for k in MALS_KEYS},
    }


def _int_bits(tensors) -> torch.Tensor:
    """The bits of every tensor, one int32 vector (16-bit values widened,
    64-bit ones as two words)."""
    parts = []
    for t in tensors:
        t = t.detach().contiguous().reshape(-1)
        parts.append(t.view(torch.int32) if t.element_size() >= 4 else t.view(torch.int16).to(torch.int32))
    return torch.cat(parts)


def _mesh_same_state(sd: dict, opt: dict, saved_sd: dict, saved_opt: dict) -> bool:
    """A state dict and an optimizer state's moments (``_opt_tensors``)
    bit for bit as saved."""
    return sd.keys() == saved_sd.keys() and all(bits_equal(v, saved_sd[k]) for k, v in sd.items()) and all(
        bits_equal(a, b) for part in ("mu", "nu") for a, b in zip(opt[part], saved_opt[part], strict=True)
    )


def _bits_agree(tensors, group) -> bool:
    """Whether every rank of ``group`` holds ``tensors`` bit for bit (the
    elementwise max over the group equals the min)."""
    import torch.distributed as dist

    if group is None or not tensors:
        return True
    bits = _int_bits(tensors)
    hi, lo = bits.clone(), bits.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    return torch.equal(hi, lo)


def _mesh_agreement(trainer) -> dict:
    """Every replicated parameter, moment, BatchNorm buffer and streaming
    state bit for bit equal over the world; every split leaf and its
    moments over its data group (its replicas)."""
    import dataclasses

    import torch.distributed as dist

    from scrubvae_torch.parallel import mesh as pmesh

    rows = pmesh.param_rows(trainer.model)
    opt = trainer.state.opt_state
    rep, split = [], []
    for p, m, v, r in zip(trainer.model.parameters(), opt.mu, opt.nu, rows):
        (rep if r is None else split).extend([p, m, v])
    rep += list(trainer.model.buffers())
    rep += [getattr(st, f.name) for states in trainer.state.scrub_state.values() for st in states.values()
            for f in dataclasses.fields(st) if isinstance(getattr(st, f.name), torch.Tensor)]
    world = dist.group.WORLD
    out = {
        "replicated_tensors": len(rep), "split_tensors": len(split),
        "replicated_bitwise": _bits_agree(rep, world),
        "split_bitwise_over_data": _bits_agree(split, trainer.mesh.data_group),
    }
    if not (out["replicated_bitwise"] and out["split_bitwise_over_data"]):
        raise AssertionError(f"mesh: ranks disagree: {out}")
    return out


def _mesh_shard_check(trainer, rows: np.ndarray) -> dict:
    """The kernel on this rank's rows of ``fc_sigma`` as the trainer's table
    launches it (its leaf word, its first element), on the live slice and
    moments and this step's gradient (``make_grad_fn``): bitwise equal to
    the plain version over the slice at that offset, and to the same rows
    of one kernel launch over the whole leaf (gathered over the model
    group, exactly); then the slice's time beside its bound, the plain
    version's and ``torch._fused_adamw_``'s, each rank timing alone on the
    card while the others wait."""
    import torch.distributed as dist

    from scrubvae_torch.ops import fused_adamw as fa
    from scrubvae_torch.parallel import mesh as pmesh

    names = [n for n, _ in trainer.model.named_parameters()]
    i = names.index(MESH_FC_SIGMA)
    opt = trainer.state.opt_state
    cpl = pmesh.split_of(trainer.model)[i]
    w, mu, nu = (t.detach().clone() for t in (list(trainer.model.parameters())[i], opt.mu[i], opt.nu[i]))
    grads, _, _ = trainer.make_grad_fn()(
        trainer.state, torch.as_tensor(pmesh.shard_batch(trainer.mesh, rows), device=trainer.device),
        trainer.loss_scale_for_epoch(1),
    )
    g = grads[MESH_FC_SIGMA].contiguous()
    lid, start = opt.table.leaf_ids[i], opt.table.starts[i]
    scal = trainer.tx._scalars(opt.count + 1, [g])
    hyper = dict(b1=trainer.tx.b1, b2=trainer.tx.b2, eps=trainer.tx.eps, wd=trainer.tx.wd)
    step = opt.step + 1
    table = fa.LeafTable([w.clone()], [mu.clone()], [nu.clone()], leaf_ids=[lid], starts=[start])
    fa.fused_adamw_multi(table, [g], scal, seed=trainer.tx.seed, step=step, **hyper)
    lr, b1c, b2c, gscale = scal.unbind(0)
    ref = fa.fused_adamw_multi_reference(
        [w], [g], [mu], [nu], lr=lr, b1c=b1c, b2c=b2c, gscale=gscale, seed=trainer.tx.seed, step=step,
        leaf_ids=[lid], starts=[start], **hyper,
    )[0]
    got = (table.w[0], table.mu[0], table.nu[0])
    err = _assert_bits(f"{MESH_FC_SIGMA} rows {cpl.row0}.. at element {start}", got, ref)
    whole = [pmesh.whole_leaf(t, cpl) for t in (w, g, mu, nu)]
    full = fa.LeafTable([whole[0].clone()], [whole[2].clone()], [whole[3].clone()], leaf_ids=[lid])
    fa.fused_adamw_multi(full, [whole[1]], scal, seed=trainer.tx.seed, step=step, **hyper)
    rows_of_full = tuple(t[cpl.row0:cpl.row0 + cpl.out_features] for t in (full.w[0], full.mu[0], full.nu[0]))
    _assert_bits(f"{MESH_FC_SIGMA} rows {cpl.row0}.. against the whole leaf's launch", got, rows_of_full)
    shard_bytes = fa.leaf_bytes([w.shape], w.element_size(), mu.element_size())
    bound_ms, bound_by = _bound(shard_bytes, w.numel())
    f32 = [[t.float()] for t in (w, g, mu, nu)]
    stepf = [torch.tensor(float(step), device=w.device)]
    timed = cuda_ms if w.is_cuda else (lambda fn, iters=0: None)  # a rehearsal on the CPU times nothing

    def times() -> dict:
        return {
            "ms": timed(lambda: fa.fused_adamw_multi(table, [g], scal, seed=trainer.tx.seed, step=step, **hyper)),
            "plain_ms": timed(lambda: fa.fused_adamw_multi_reference(
                [w], [g], [mu], [nu], lr=lr, b1c=b1c, b2c=b2c, gscale=gscale, seed=trainer.tx.seed, step=step,
                leaf_ids=[lid], starts=[start], **hyper), iters=5),
            "library_ms": timed(lambda: torch._fused_adamw_(
                *f32, [], stepf, lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
                maximize=False)),
        }

    # the ranks share the card: each times its slice alone, the others
    # waiting at the barrier without work on the card
    for r in range(dist.get_world_size()):
        dist.barrier()
        if dist.get_rank() == r:
            rec = times()
    dist.barrier()
    rec.update({
        "leaf": MESH_FC_SIGMA, "shape": list(w.shape), "whole_shape": list(whole[0].shape), "row0": cpl.row0,
        "start": start, "leaf_word": lid, "variant": f"w {w.dtype}, m {mu.dtype}".replace("torch.", ""),
        "bitwise_plain": True, "bitwise_whole_leaf_rows": True, "max_abs_err": err, "bytes": shard_bytes,
        "bound_ms": bound_ms, "bound_by": bound_by, "timed_alone": True,
    })
    return rec


def mesh_rank(rank: int, world: int, tmp: str, label: str, spec: dict, dims: dict) -> None:
    """One rank of a mesh on the shared card: the f32 step from the
    reference's weights, rows and noise (rank 0 holds it to the reference
    with ``scrubvae_torch.train.parity``); then the bf16 flagship's timed
    steps, its kernel launches a step, the ranks' bitwise agreement and,
    with a model axis, the kernel's check on this rank's slice; on the
    4-rank mesh a save restored into the same mesh bit for bit. Writes its
    readings to ``tmp/{label}_rank{rank}.json``."""
    import torch.distributed as dist

    from scrubvae_torch.parallel import mesh as pmesh
    from scrubvae_torch.train import parity
    from scrubvae_torch.utils import checkpoint as ckpt

    cuda = dims["device"] != "cpu"
    if cuda:
        torch.cuda.set_device(torch.device(dims["device"]))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    t_mesh = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init_{label}", rank=rank, world_size=world)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    last = [time.perf_counter()]

    def mark(part: str) -> None:
        """Seconds of this rank's part since the last mark (the phase's
        breakdown)."""
        sync()
        now = time.perf_counter()
        out["seconds"][part] = now - last[0]
        last[0] = now

    try:
        out = {"rank": rank, "label": label, "mesh": spec, "seconds": {}}
        trainer, ds = _mesh_build(dims, spec, parity=True)
        mark("build_f32")
        rows, eps = _mesh_inputs(dims, len(ds))
        sync()
        t0 = time.perf_counter()
        got = _mesh_one_step(trainer, rows, eps)
        sync()
        out["parity_step_s"] = time.perf_counter() - t0
        if rank == 0:
            ref = torch.load(f"{tmp}/reference.pt", map_location=trainer.device, weights_only=True)
            ref["mals"] = {k: v.cpu() for k, v in ref["mals"].items()}
            out["parity"] = {
                "max_loss_rel": parity.check_losses(ref["losses"], got["losses"], 1e-4),
                **parity.check_grads(ref["grads"], got["grads"]),
                # at full width: four ulps, the reference's float64 twin marking
                # where its own sign is unsure, and the latitude of gradients
                # small beside Adam's eps (parity's docstring)
                **parity.check_weights(
                    ref["w1"], got["w1"], ref["grads"], ulps=4, unsure=ref["unsure"], got_grads=got["grads"],
                ),
                "max_mals_rel": parity.check_mals(ref["mals"], got["mals"], 1e-4),
            }
            del ref
        del got
        mark("parity_step_and_check")
        if label == "data2_model2":
            run = f"{tmp}/{label}_run"
            ckpt.save_train_state(run, 1, trainer.model, trainer.state, trainer.np_rng, mesh=trainer.mesh)
            dist.barrier()
            saved = torch.load(f"{run}/checkpoints/epoch_1.pt", weights_only=True)
            mine = ckpt._cpu_state_dict(trainer.model)
            opt = ckpt._opt_tensors(trainer.state.opt_state, pmesh.split_of(trainer.model))
            if not _mesh_same_state(mine, opt, saved["model"], saved["opt"]):
                raise AssertionError("mesh: the saved state differs from the ranks' own")
            fresh, _ = _mesh_build(dims, spec, parity=True)
            back = ckpt.load_train_state(run, 1, fresh.model, fresh.state, fresh.np_rng)
            fresh.state = back
            restored = ckpt._cpu_state_dict(fresh.model)
            ropt = ckpt._opt_tensors(fresh.state.opt_state, pmesh.split_of(fresh.model))
            if not _mesh_same_state(restored, ropt, saved["model"], saved["opt"]):
                raise AssertionError("mesh: a restore into the same mesh differs from the save")
            out["save_restore_same_mesh_bitwise"] = True
            del saved, mine, opt, fresh, back, restored, ropt
            mark("save_restore")
        del trainer
        if cuda:
            torch.cuda.empty_cache()

        warmup, steps = MESH_STEPS[label]
        trainer, ds = _mesh_build(dims, spec, parity=False)
        mark("build_bf16")
        idx = np.random.default_rng(2).integers(0, len(ds), (warmup + steps + 1, dims["batch"]))
        local = torch.as_tensor(pmesh.shard_batch(trainer.mesh, idx, axis=1), device=trainer.device)
        scale = trainer.loss_scale_for_epoch(1)
        for i in range(warmup):
            trainer.state, _ = trainer.train_step(trainer.state, local[i], scale)
        sync()
        _reset_launches()
        t0 = time.perf_counter()
        for i in range(warmup, warmup + steps):
            trainer.state, m = trainer.train_step(trainer.state, local[i], scale)
        sync()
        out["step_ms"] = (time.perf_counter() - t0) / steps * 1e3
        launches = _launches()
        out["kernel_launches"], out["launches_per_step"] = launches, launches / steps
        out["last_total"] = float(m["total"])
        if launches != 2 * steps or not math.isfinite(out["last_total"]):
            raise AssertionError(f"mesh {label} rank {rank}: {launches} launches in {steps} steps, total {out['last_total']}")
        mark("bf16_steps")
        out["agreement"] = _mesh_agreement(trainer)
        mark("agreement")
        if spec.get("model", 1) > 1:
            out["shard"] = _mesh_shard_check(trainer, idx[-1])
            mark("shard_check")
        if cuda:
            out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del trainer
        out["wall_s"] = time.perf_counter() - t_mesh
        with open(f"{tmp}/{label}_rank{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
        if cuda:
            torch.cuda.empty_cache()


def mesh_worker(proc: int, tmp: str, dims: dict, done: list) -> None:
    """One process of the mesh phase: rank ``proc`` of every mesh of
    ``MESH_SPECS`` that has one, in order, so the processes start once for
    all the meshes. A process with no rank in a mesh waits for
    ``done[i]``, which rank 0 sets when mesh i ends, blocked without
    touching the card or spinning, so it does not slow the mesh it sits
    out."""
    for i, (label, spec, world) in enumerate(MESH_SPECS):
        if proc < world:
            mesh_rank(proc, world, tmp, label, spec, dims)
            if proc == 0:
                done[i].set()
        else:
            done[i].wait()


def mesh_phase(card: str, dims: dict = MESH_DIMS) -> dict:
    """``train.mesh`` on the one card: for each of ``MESH_SPECS`` the ranks
    (``torch.multiprocessing``, gloo, a file store) share ``dims["device"]``
    under deterministic algorithms. The single-rank f32 step of the
    flagship's width is the reference (``_mesh_build``); every mesh's rank 0
    holds its own step to it with the step-1 bounds of
    ``scrubvae_torch.train.parity``; ranks agree bit for bit; the bf16
    flagship's steps launch the kernel twice a step on every rank; a model
    axis's slices pass ``_mesh_shard_check``; the 4-rank mesh's save
    restores into the same mesh and into one device bit for bit. Prints
    each mesh's step time per rank: ranks sharing one card over gloo, not a
    scaling number."""
    import torch.multiprocessing as mp

    from scrubvae_torch.train import parity
    from scrubvae_torch.utils import checkpoint as ckpt

    cuda = dims["device"] != "cpu"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        torch.use_deterministic_algorithms(True)
        if cuda:
            torch.backends.cudnn.deterministic = True
        t_ref = time.perf_counter()
        try:
            trainer, ds = _mesh_build(dims, None, parity=True)
            rows, eps = _mesh_inputs(dims, len(ds))
            # the reference's float64 twin marks where its own f32 sign is unsure
            g64 = parity.grads_float64(trainer, torch.as_tensor(rows), torch.from_numpy(eps), device=trainer.device)
            ref = _mesh_one_step(trainer, rows, eps)
            ref["unsure"] = parity.sign_unsure(ref["grads"], {n: g.to(trainer.device) for n, g in g64.items()})
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
        torch.save(ref, f"{tmp}/reference.pt")
        del trainer, ref
        reference_s = time.perf_counter() - t_ref
        if cuda:
            torch.cuda.empty_cache()
        meshes = {}
        t0 = time.perf_counter()
        done = [mp.get_context("spawn").Event() for _ in MESH_SPECS]
        mp.spawn(mesh_worker, args=(tmp, dims, done), nprocs=max(world for _, _, world in MESH_SPECS))
        spawn_s = time.perf_counter() - t0
        for label, spec, world in MESH_SPECS:
            ranks = []
            for r in range(world):
                with open(f"{tmp}/{label}_rank{r}.json") as f:
                    ranks.append(json.load(f))
            meshes[label] = {
                "mesh": spec, "ranks": world, "wall_s": ranks[0]["wall_s"],
                "parity": ranks[0]["parity"],
                "step_ms_per_rank": [r["step_ms"] for r in ranks],
                "launches_per_step_per_rank": [r["launches_per_step"] for r in ranks],
                "agreement": ranks[0]["agreement"],
                "peak_mem_gib_per_rank": [r.get("peak_mem_gib") for r in ranks],
                "rank0_seconds": ranks[0]["seconds"],
                "shards": [r["shard"] for r in ranks if "shard" in r],
            }
            log(f"mesh {label} ({card}; {world} ranks sharing one card over gloo, not a scaling number): "
                + json.dumps(meshes[label]))
        # the 4-rank mesh's save restored into one device
        fresh, _ = _mesh_build(dims, None, parity=True)
        run = f"{tmp}/data2_model2_run"
        fresh.state = ckpt.load_train_state(run, 1, fresh.model, fresh.state, fresh.np_rng)
        saved = torch.load(f"{run}/checkpoints/epoch_1.pt", weights_only=True)
        restored = ckpt._cpu_state_dict(fresh.model)
        ropt = ckpt._opt_tensors(fresh.state.opt_state)
        if not _mesh_same_state(restored, ropt, saved["model"], saved["opt"]):
            raise AssertionError("mesh: the 4-rank save does not restore into one device bit for bit")
        del fresh, saved, restored, ropt
        rec = {"card": card, "meshes": meshes, "restore_into_one_device_bitwise": True, "reference_s": reference_s,
               "ranks_s": spawn_s}
        log(f"mesh ({card}): the single-rank reference and its float64 twin {reference_s:.1f} s, the ranks' "
            f"processes {spawn_s:.1f} s; the 4-rank save restored into one device bit for bit")
        return rec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if cuda:
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 16: the train and validation epochs as CUDA graphs
# ---------------------------------------------------------------------------

GRAPH_STEPS = (20, 4)  # the flagship's two graph epochs against its eager epochs
GRAPH_VAL_FRAMES = 11500  # 4 ids: 5652 windows, 11 full batches of 512 and a tail
GRAPH_FULL_VAL_FRAMES = 2600  # 4 ids: 1200 windows, 2 full batches of 512 and a tail
GRAPH_SMALL_VAL_FRAMES = 400  # 4 ids: 100 windows, 6 full batches of 16 and a tail
GRAPH_FULL_ROWS = (6, 6)  # 5_full's two epochs, an MCMI refresh between them
GRAPH_SMALL_ROWS = (4, 3)  # the small paths' two epochs, each followed by a validation epoch
GRAPH_SMALL = {  # the small paths: label -> (config, model, train overrides, build kwargs)
    "sgd": (None, {}, {"optimizer": "sgd", "clip_norm": 1}, {}),
    "unfused_adam": (None, {}, {"fused_optimizer": False}, {}),
    "beta_prior": (None, {"prior": "beta"}, {}, {}),
    "transformer": (None, {"type": "transformer", "z_dim": 16, "window": 51, "diag": False}, {}, {}),
    "sane_4_full": ("sane/4_full", {}, {}, {"small": False, "val_frames": 2 * GRAPH_SMALL_VAL_FRAMES}),
}
GRAPH_KERNEL_REPLAYS = 3


def _graph_trainer(run: pathlib.Path, scan: bool, config: str = None, model: dict = None, small: bool = True,
                   val_frames: int = GRAPH_SMALL_VAL_FRAMES, **train):
    """A trainer on ``profile_step.build_from_config``'s synthetic splits
    (train and a validation split of ``val_frames`` frames) from a config
    file: ``configs/{config}.yaml``, or the bench's flagship, with
    ``model`` and ``train`` entries overridden, at the bench's small
    widths with ``small``; ``train.scan_epoch`` = ``scan``."""
    from scrubvae_torch import bench, profile_step

    if config is None:
        cfg = bench.bench_config(512, 51, 128, bench.FULL_CH, True)
    else:
        import yaml

        cfg = yaml.safe_load((ROOT / "configs" / f"{config}.yaml").read_text())
    cfg["model"].update(model or {})
    cfg["train"].update(train)
    cfg = _write_config(run / f"{'graph' if scan else 'eager'}", cfg)
    return profile_step.build_from_config(
        pathlib.Path(cfg["out_path"]) / "model_config.yaml", DEVICE, small=small, scan_epoch=scan,
        val_frames=val_frames,
    )


def _graph_run(trainer, ds, schedule) -> dict:
    """``schedule``'s epochs through ``trainer``: ("train", epoch, steps)
    on rows drawn from a fixed numpy seed, ("val", epoch); each epoch's
    metrics and host time, the validation mu, the whole trainer state
    after (the validation generator's state with the others), the kernel
    launches, and the peak memory above what was allocated when the
    schedule began (so not counting what earlier phases still hold)."""
    rng = np.random.default_rng(7)
    out = {"metrics": [], "seconds": [], "mu": []}
    _reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["start_mem_gib"] = torch.cuda.memory_allocated() / 2**30
    for kind, epoch, *steps in schedule:
        t0 = time.perf_counter()
        if kind == "train":
            rows = rng.integers(0, len(ds), (steps[0], trainer.batch_size))
            out["metrics"].append(trainer.train_epoch(epoch, rows))
        else:
            m, z = trainer.test_epoch(epoch)
            out["metrics"].append(m)
            out["mu"].append(torch.from_numpy(z))
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
    out["state"] = _trainer_state(trainer)
    out["state"]["generator"].append(trainer._eval_gen.get_state().clone())
    out["launches"] = _launches()
    out["steps"] = trainer.state.step
    out["captures"] = trainer.graph_captures
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30 - out["start_mem_gib"]
    return out


def _graph_compare(label: str, run: pathlib.Path, schedule, **build) -> dict:
    """The same epochs eagerly (``scan_epoch: false``) and as graphs, with
    deterministic algorithms: metrics, validation mu and state bit for bit,
    the same kernel launches (the graph's counted from its replays)."""
    runs = {}
    for scan in (False, True):
        trainer, ds = _graph_trainer(run / label, scan, **build)
        if trainer.use_graphs != scan:
            raise AssertionError(f"graph {label}: scan_epoch {scan} but use_graphs {trainer.use_graphs}")
        runs[scan] = _graph_run(trainer, ds, schedule)
        trainer.release_graphs()
        del trainer, ds
        torch.cuda.empty_cache()
    eager, graph = runs[False], runs[True]
    bad = _same_state(eager["state"], graph["state"])
    if eager["metrics"] != graph["metrics"]:
        bad.append("metrics")
    if not all(bits_equal(a, b) for a, b in zip(eager["mu"], graph["mu"])):
        bad.append("validation mu")
    if (eager["launches"], eager["steps"]) != (graph["launches"], graph["steps"]):
        bad.append(f"launches/steps {eager['launches']}/{eager['steps']} vs {graph['launches']}/{graph['steps']}")
    if bad:
        raise AssertionError(f"graph {label}: the graph epochs differ from the eager ones in {bad}")
    rec = {
        "bitwise_equal": True, "launches": graph["launches"], "steps": graph["steps"],
        "launches_per_step": graph["launches"] / max(graph["steps"], 1), "captures": graph["captures"],
        "epoch_seconds_eager": eager["seconds"], "epoch_seconds_graph": graph["seconds"],
        "peak_mem_gib_eager": eager["peak_mem_gib"], "peak_mem_gib_graph": graph["peak_mem_gib"],
        "start_mem_gib": [eager["start_mem_gib"], graph["start_mem_gib"]],
        "total_train": [m.get("total") for m in graph["metrics"]],
    }
    log(f"graph {label}, graph against eager: " + json.dumps(rec))
    return rec


def graph_kernel_check(params, moments, label: str) -> dict:
    """The kernel captured in a CUDA graph with its step word (one
    ``count.add_(1)`` and one ``fused_adamw_multi`` over a table of
    ``params``' shapes and dtypes and ``moments``' dtypes, random values)
    and replayed ``GRAPH_KERNEL_REPLAYS`` times: after replay t, every leaf
    bitwise equal to the plain version at step t from the leaves before
    it. Then the replayed pass's time (CUDA events around 20 replays) and
    device time beside the eager call's."""
    from scrubvae_torch.ops import fused_adamw as fa

    scal, hyper, _ = _outer_hyper()
    gen = torch.Generator(device="cuda").manual_seed(2)

    def randn(like, scale, dtype):
        return (torch.randn(like.shape, generator=gen, device="cuda") * scale).to(dtype)

    gs = [randn(p, 1e-2, p.dtype) for p in params]
    table = fa.LeafTable([randn(p, 0.05, p.dtype) for p in params], [randn(m, 1e-3, m.dtype) for m in moments],
                         [(randn(m, 1e-2, torch.float32) ** 2).to(m.dtype) for m in moments])
    count = torch.zeros((), dtype=torch.int32, device="cuda")
    seed = 17

    def step():
        count.add_(1)
        fa.fused_adamw_multi(table, gs, scal, seed=seed, step=count, **hyper)

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    lr, b1c, b2c, gscale = scal.unbind(0)
    err = 0.0
    for t in range(1, GRAPH_KERNEL_REPLAYS + 1):
        before = [[x.clone() for x in xs] for xs in (table.w, table.mu, table.nu)]
        graph.replay()
        refs = fa.fused_adamw_multi_reference(
            *before[:1], gs, *before[1:], lr=lr, b1c=b1c, b2c=b2c, gscale=gscale, seed=seed, step=t, **hyper
        )
        torch.cuda.synchronize()
        if int(count) != t:
            raise AssertionError(f"graph kernel {label}: the step word reads {int(count)} after replay {t}")
        for i, ref in enumerate(refs):
            err = max(err, _assert_bits(f"replay {t} leaf {i} of the {label} set", (table.w[i], table.mu[i], table.nu[i]), ref))
        del before, refs
    rec = {
        "leaves": len(params), "elements": sum(table.numel), "replays_bitwise": GRAPH_KERNEL_REPLAYS,
        "max_abs_err": err,
        "graph_pass_ms": cuda_ms(graph.replay),
        "graph_pass_device_ms": device_ms(graph.replay),
        "eager_pass_ms": cuda_ms(step),
    }
    log(f"graph kernel fused_adamw {label} set replayed: " + json.dumps(rec))
    del graph, table, gs
    torch.cuda.empty_cache()
    return rec


def graph_readings() -> dict:
    """``profile_step``'s line of the flagship eager and in a graph, and
    the bench's step time and rate both ways (20 timed steps)."""
    from scrubvae_torch import bench, profile_step

    out = {}
    for label, flags in (("eager", ["--per-step"]), ("graph", [])):
        rec = profile_step.run(profile_step.parse_args(["--steps", "20", *flags]))
        out[f"profile_{label}"] = rec
        log(f"graph profile_step flagship {label}: " + json.dumps(rec))
        torch.cuda.empty_cache()
        b = bench.run(bench.parse_args(["--steps", "20", "--warmup", "3", *flags]))
        out[f"bench_{label}"] = b
        log(f"graph bench {label}: " + json.dumps(b))
        torch.cuda.empty_cache()
    return out


def graph_phase(card: str) -> dict:
    """The train and validation epochs as CUDA graphs against the eager
    epochs, bit for bit under deterministic algorithms; the kernel
    replayed in a graph against its plain version; the readings."""
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_graph_"))
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        flagship = _graph_compare(
            "flagship", tmp, [("train", 1, GRAPH_STEPS[0]), ("val", 1), ("train", 2, GRAPH_STEPS[1]), ("val", 2)],
            small=False, val_frames=GRAPH_VAL_FRAMES,
        )
        full = _graph_compare(
            "5_full", tmp, [("train", 1, GRAPH_FULL_ROWS[0]), ("val", 1), ("train", 2, GRAPH_FULL_ROWS[1])],
            config="ladder/5_full", small=False, val_frames=GRAPH_FULL_VAL_FRAMES,
        )
        if full["captures"] < 3:
            raise AssertionError(f"graph 5_full: {full['captures']} captures; the MCMI refresh must recapture")
        small = {
            label: _graph_compare(
                label, tmp,
                [("train", 1, GRAPH_SMALL_ROWS[0]), ("val", 1), ("train", 2, GRAPH_SMALL_ROWS[1]), ("val", 2)],
                config=config, model=model, **train, **build,
            )
            for label, (config, model, train, build) in GRAPH_SMALL.items()
        }
        compare_s = time.perf_counter() - t0
        from scrubvae_torch import bench

        trainer, _ = bench.build(512, 51, 128, bench.FULL_CH, DEVICE)
        kernel = graph_kernel_check(list(trainer.model.parameters()), trainer.state.opt_state.mu, "flagship")
        del trainer
        torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(tmp, ignore_errors=True)
    readings = graph_readings()
    rec = {"flagship": flagship, "5_full": full, "small": small, "kernel": kernel, "readings": readings,
           "compare_seconds": compare_s}
    log(f"graph phase ({card}): " + json.dumps({
        "compare_seconds": compare_s,
        "flagship_val_seconds_eager": flagship["epoch_seconds_eager"][1::2],
        "flagship_val_seconds_graph": flagship["epoch_seconds_graph"][1::2],
        "flagship_peak_mem_gib_above_start": [flagship["peak_mem_gib_eager"], flagship["peak_mem_gib_graph"]],
        "flagship_start_mem_gib": flagship["start_mem_gib"],
    }))
    return rec


# ---------------------------------------------------------------------------
# phase 17: the train step's spans
# ---------------------------------------------------------------------------

SPANS_STEPS = 20  # the flagship's graph epochs
SPANS_SLEEP_CYCLES = 4_000_000  # torch.cuda._sleep between two stamps: about 2 ms at 1980 MHz
SPANS_SLEEP_TOL_MS = 0.02
# one step's stamps after its first, in the step's order
SPANS_ORDER = ("data", "encoder", "decoder", "scrub_forward", "losses", "scrub_forward", "backward", "optimizer",
               "scrub_update")


def stamp_checks() -> dict:
    """The stamp kernel's bookkeeping against the CPU's, a known interval
    against CUDA events, and the stamp's device time (phase 17)."""
    from scrubvae_torch.utils import profiling

    n = len(profiling.SLOTS)
    counts = {}
    for dev in (DEVICE, "cpu"):
        spans = profiling.StepSpans(dev)
        spans.start_epoch()
        first = None
        for _ in range(3):
            for slot in ("replay_gap",) + SPANS_ORDER:
                spans.stamp(slot)
                if first is None:
                    first = int(spans.buf[2 * n])
        buf = spans.buf.cpu().tolist()
        spans.take(buf[: 2 * n])
        if min(buf[:n]) < 0 or sum(buf[:n]) != buf[2 * n] - first:
            raise AssertionError(f"spans {dev}: totals {buf[:n]} from {first} to {buf[2 * n]}")
        counts[dev] = spans.counts
    want = {s: 3 * SPANS_ORDER.count(s) for s in profiling.SLOTS}
    want["replay_gap"] = 2
    if not counts[DEVICE] == counts["cpu"] == want:
        raise AssertionError(f"spans: counts on the card {counts[DEVICE]}, on the CPU {counts['cpu']}, not {want}")
    if profiling.launch_stamp.launches != 3 * (1 + len(SPANS_ORDER)):
        raise AssertionError(f"spans: {profiling.launch_stamp.launches} stamp launches for 30 stamps")

    spans = profiling.StepSpans(DEVICE)
    spans.start_epoch()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPANS_SLEEP_CYCLES)  # the device busy while the host queues the rest
    spans.stamp("data")
    start.record()
    torch.cuda._sleep(SPANS_SLEEP_CYCLES)
    end.record()
    spans.stamp("encoder")
    torch.cuda.synchronize()
    stamp_ms = int(spans.buf[profiling.SLOTS.index("encoder")]) / 1e6
    event_ms = start.elapsed_time(end)
    if event_ms < 1.0 or abs(stamp_ms - event_ms) > SPANS_SLEEP_TOL_MS:
        raise AssertionError(f"spans: a sleep of {event_ms} ms between events read {stamp_ms} ms between stamps")
    rec = {"counts": want, "sleep_ms_events": event_ms, "sleep_ms_stamps": stamp_ms,
           "stamp_device_us": 1e3 * device_ms(lambda: spans.stamp("data"), iters=200)}
    log("spans stamps: " + json.dumps(rec))
    return rec


def spans_phase(card: str) -> dict:
    """The stamps, then the flagship's traced and untraced graph epochs
    (phase 17)."""
    from scrubvae_torch.utils import profiling

    profiling.launch_stamp.launches = 0
    stamps = stamp_checks()
    profiling.launch_stamp.launches = 0
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_spans_"))
    try:
        trainer, ds = _graph_trainer(tmp, True, small=False)
        rng = np.random.default_rng(17)

        def epoch(e: int) -> None:
            trainer.train_epoch(e, rng.integers(0, len(ds), (SPANS_STEPS, trainer.batch_size)))

        def expect(what: str, got, want) -> None:
            if got != want:
                raise AssertionError(f"spans flagship: {what} {got}, not {want}")

        epoch(1)  # captures the untraced step
        syncs, replays = trainer.host_syncs, trainer.replays
        with profiling.count_syncs(DEVICE) as counted:
            epoch(2)
        expect("an untraced epoch's host syncs and readbacks", (counted.n, trainer.host_syncs - syncs), (1, 1))
        expect("an untraced epoch's replays", trainer.replays - replays, SPANS_STEPS)
        expect("an untraced epoch's stamps", profiling.launch_stamp.launches, 0)
        captures = trainer.graph_captures
        trainer.set_tracing(True)
        epoch(2)  # captures the traced step
        expect("captures after tracing on", trainer.graph_captures, captures + 1)
        expect("the recapturing epoch's stamps", profiling.launch_stamp.launches, 10 * SPANS_STEPS)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        epoch(2)
        end.record()
        torch.cuda.synchronize()
        expect("two traced epochs' stamps", profiling.launch_stamp.launches, 2 * 10 * SPANS_STEPS)
        want = {s: SPANS_STEPS * SPANS_ORDER.count(s) for s in profiling.SLOTS}
        want["replay_gap"] = SPANS_STEPS - 1
        expect("a traced epoch's charges", trainer.spans.counts, want)
        slots_ms = sum(trainer.spans.totals_ns.values()) / 1e6
        epoch_ms = start.elapsed_time(end)
        if not 0.97 * epoch_ms <= slots_ms <= epoch_ms:
            raise AssertionError(f"spans flagship: the slots sum to {slots_ms} ms in an epoch of {epoch_ms} ms")
        ms = trainer.spans.ms_per_step()
        trainer.set_tracing(False)
        epoch(2)
        expect("captures after tracing off", trainer.graph_captures, captures + 2)
        expect("stamps after tracing off", profiling.launch_stamp.launches, 2 * 10 * SPANS_STEPS)
        trainer.release_graphs()
        del trainer, ds
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"stamps": stamps, "slot_ms_per_step": ms, "slots_ms": slots_ms, "epoch_ms": epoch_ms,
           "steps": SPANS_STEPS}
    log(f"spans phase ({card}): " + json.dumps(rec))
    return rec


SOLVES_C, SOLVES_D, SOLVES_B = 4, 128, 512  # full5's QDA on ids: 4 classes, z 128, batch 512
SOLVES_CELL, SOLVES_SEED = "full5.b512", 1_718_281_828
SOLVES_PER_STEP = 4 * SOLVES_C + 2 + 1  # full5's factorizations a step: QDA's 4C, MALS's 2, the projection's 1
SOLVES_PROFILED_STEPS = 3
FACTOR_SHAPES = ((16, 128, 128), (2, 128, 128), (3, 3))  # QDA's, MALS's and the projection's factors


def pivoted_lu(name: str) -> bool:
    """Whether a kernel's name is a pivoted LU's: its row swaps (``laswp``)
    or a ``getrf`` other than cuSOLVER's unpivoted one (``getrf_wo_pivot``,
    which its Cholesky factor runs)."""
    name = name.lower()
    return "laswp" in name or ("getrf" in name and "wo_pivot" not in name)


def kernel_names(fn) -> list:
    """The names of the kernels one call of ``fn`` launches (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def _solve_inputs(gen):
    """A QDA state of full5's shape moved from the identity by five
    ``qda_update`` calls, a MALS state of z 128 after five updates, and a
    batch of latents and labels."""
    from scrubvae_torch.models import scrubbers as scr

    C, D, B = SOLVES_C, SOLVES_D, SOLVES_B
    mix = torch.randn(D, D, generator=gen, device=DEVICE) / math.sqrt(D)
    shift = torch.randn(C, D, generator=gen, device=DEVICE)

    def batch():
        y = torch.randint(0, C, (B,), generator=gen, device=DEVICE)
        return torch.randn(B, D, generator=gen, device=DEVICE) @ mix + shift[y], y

    qda = scr.qda_init(D, torch.arange(C, device=DEVICE), device=DEVICE)
    mals = scr.mals_init(D, 1, device=DEVICE)
    for _ in range(5):
        x, y = batch()
        qda = scr.qda_update(qda, x, y)
        mals = scr.mals_update(mals, x, x[:, :1] + 0.1 * torch.randn(B, 1, generator=gen, device=DEVICE))
    x, y = batch()
    return qda, mals, x, y


def solves_capture(qda, mals, x, y) -> dict:
    """The QDA likelihoods with their gradient in ``x`` and MALS's solve,
    captured: no host sync, a replay bitwise equal to the eager call."""
    from scrubvae_torch.models import scrubbers as scr
    from scrubvae_torch.train.graph import side_stream, warm_up
    from scrubvae_torch.utils.profiling import count_syncs

    xg = x.clone().requires_grad_(True)

    def step():
        loss, _ = scr.qda_loss(qda, xg, y)
        (gx,) = torch.autograd.grad(loss, [xg])
        return [loss.detach(), gx, *scr.mals_forward(mals, x)]

    with count_syncs(DEVICE) as warm_syncs:
        eager = [t.clone() for t in warm_up(step)]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side_stream()):  # a host sync inside would end the capture with an error
        out = step()
    with count_syncs(DEVICE) as replay_syncs:
        graph.replay()
    torch.cuda.synchronize()
    if (warm_syncs.n, replay_syncs.n) != (0, 0):
        raise AssertionError(f"solves: {warm_syncs.n} host syncs in the eager call, {replay_syncs.n} in the replay")
    same = [bits_equal(a, b) for a, b in zip(out, eager)]
    if not all(same):
        raise AssertionError(f"solves: the replay differs from the eager call in outputs {same}")
    del graph
    return {"host_syncs": warm_syncs.n + replay_syncs.n, "replay_bitwise": True}


def solves_timings(qda, mals, x, y) -> dict:
    """Device ms (profiler) of the QDA likelihoods' Cholesky chain beside
    the pivoted LU route, and of the factor-solve and MALS variants."""
    from scrubvae_torch.models import scrubbers as scr
    from scrubvae_torch.ops import smallsolve as ss

    m = torch.cat([qda.m0a, qda.m1a, qda.m0b, qda.m1b])
    S = torch.cat([qda.S0a, qda.S1a, qda.S0b, qda.S1b])
    xg = x.clone().requires_grad_(True)

    def lu_cgll(xx):
        diff = xx[None] - m[:, None]
        sol = torch.linalg.solve(S, diff.transpose(-1, -2))
        return -0.5 * (torch.linalg.slogdet(S)[1][:, None] + torch.einsum("cbd,cdb->cb", diff, sol))

    def with_grad(fn):
        return lambda: torch.autograd.grad(fn(xg).sum(), [xg])

    new, lib = scr._cgll(x, m, S), lu_cgll(x)
    rel = float((new - lib).abs().max() / lib.abs().max())
    A = torch.stack([mals.Sxx0, mals.Sxx1])
    Bm = torch.stack([mals.Sxy0, mals.Sxy1])
    L = ss.spd_factor(A)
    Lq = ss.spd_factor(S)
    rhs = x.T.expand(S.shape[0], -1, -1).contiguous()

    def two_trsm(LL, BB):
        half = torch.linalg.solve_triangular(LL, BB, upper=False)
        return torch.linalg.solve_triangular(LL.mT, half, upper=True)

    def spd(shape):
        a = torch.randn(*shape, generator=torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
        return a @ a.mT + shape[-1] * torch.eye(shape[-1], device=DEVICE)

    rec = {
        "factor_kernels": {"x".join(map(str, sh)): kernel_names(lambda a=spd(sh): ss.spd_factor(a))
                           for sh in FACTOR_SHAPES},
        "qda_rel_diff_lu": rel,
        "qda_forward_ms": device_ms(lambda: scr._cgll(x, m, S)),
        "qda_forward_library_ms": device_ms(lambda: lu_cgll(x)),
        "qda_fwd_bwd_ms": device_ms(with_grad(lambda xx: scr._cgll(xx, m, S))),
        "qda_fwd_bwd_library_ms": device_ms(with_grad(lu_cgll)),
        "factor_16x128_ms": device_ms(lambda: ss.spd_factor(S)),
        "cholesky_solve_16x128x512_ms": device_ms(lambda: torch.cholesky_solve(rhs, Lq)),
        "two_trsm_16x128x512_ms": device_ms(lambda: two_trsm(Lq, rhs)),
        "cholesky_solve_2x128x1_ms": device_ms(lambda: torch.cholesky_solve(Bm, L)),
        "two_trsm_2x128x1_ms": device_ms(lambda: two_trsm(L, Bm)),
        "mals_batched_ms": device_ms(lambda: ss.spd_solve(A, Bm)),
        "mals_two_calls_ms": device_ms(lambda: (ss.spd_solve(A[0], Bm[0]), ss.spd_solve(A[1], Bm[1]))),
        "mals_library_ms": device_ms(lambda: torch.linalg.solve(A, Bm)),
        "mals_forward_ms": device_ms(lambda: scr.mals_forward(mals, x)),
    }
    return rec


def solves_cell() -> dict:
    """The ``full5.b512`` cell as the benchmark sets it up: the kernels of
    one replayed step, then its warm epochs and window with the solve
    counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from benchmark import run as brun

    su = brun.set_up(SOLVES_CELL, SOLVES_SEED, DEVICE)
    trainer, ds = su.trainer, su.ds
    seconds = 40.0
    epochs = brun.warm_epochs(SOLVES_CELL, seconds) + brun.window_epochs(SOLVES_CELL, seconds)
    before_f, before_n = trainer.spd_factorizations, trainer.spd_not_pd
    steps0 = trainer.state.step
    t0 = time.perf_counter()
    for e in range(1, epochs + 1):
        trainer.train_epoch(e)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    steps = trainer.state.step - steps0
    per_step, not_pd = (trainer.spd_factorizations - before_f) / steps, trainer.spd_not_pd - before_n
    rows = np.random.default_rng(SOLVES_SEED).integers(0, len(ds), (SOLVES_PROFILED_STEPS, trainer.batch_size))
    replays = trainer.replays
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train_epoch(epochs + 1, rows)
        torch.cuda.synchronize()
    if trainer.replays - replays != SOLVES_PROFILED_STEPS:
        raise AssertionError(f"solves {SOLVES_CELL}: {trainer.replays - replays} replays in the profiled epoch")
    kernels = {e.key: e.self_device_time_total / 1e3 / SOLVES_PROFILED_STEPS
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    lu = sorted(k for k in kernels if pivoted_lu(k))
    solver = {k: v for k, v in kernels.items()
              if any(n in k.lower() for n in ("potr", "trsm", "chol", "laswp", "getr", "trsv"))}
    rec = {
        "cell": SOLVES_CELL, "seed": SOLVES_SEED, "epochs": epochs, "steps": steps, "run_s": run_s,
        "spd_factorizations_per_step": per_step, "spd_not_pd": not_pd,
        "kernel_names_per_step": len(kernels), "lu_kernels": lu,
        "solver_kernels_ms_per_step": solver,
    }
    trainer.release_graphs()
    del trainer, ds, su
    torch.cuda.empty_cache()
    log("solves cell: " + json.dumps(rec))
    if lu:
        raise AssertionError(f"solves {SOLVES_CELL}: LU kernels in a replayed step: {lu}")
    if rec["spd_not_pd"] != 0 or rec["spd_factorizations_per_step"] != SOLVES_PER_STEP:
        raise AssertionError(f"solves {SOLVES_CELL}: counts {rec}")
    return rec


def solves_phase(card: str) -> dict:
    """The solves captured and timed, then full5's cell (phase 18)."""
    from scrubvae_torch.train.graph import capturable_linalg

    gen = torch.Generator(device=DEVICE).manual_seed(SOLVES_SEED)
    with capturable_linalg():
        inputs = _solve_inputs(gen)
        rec = {"capture": solves_capture(*inputs), "timings": solves_timings(*inputs)}
    del inputs
    log("solves timings: " + json.dumps(rec))
    rec["cell"] = solves_cell()
    log(f"solves phase ({card}): " + json.dumps(rec))
    return rec


NESTED_CELLS = ("transformer.b512", "flagship.b512", "full5.b512")
NESTED_SEED, NESTED_STEPS = 1_902_030_405, 20
NESTED_DRAWS_PER_STEP = 22 * 512 * 51 * 128 + 8 * 51 * 51 + 4 * 51  # the transformer cell's masks
NESTED_PER_STEP = 2 * (12 + 8)  # a pair a block: 8 self- and 4 cross-attentions, 8 feed-forward blocks


def eager_draws(vae, data, train: bool) -> int:
    """The values ``torch.rand`` draws in one forward of ``vae`` on
    ``data``, in training mode or in eval mode, from a generator of its
    own (the trainer's is left alone)."""
    drawn, rand = [0], torch.rand

    def counting(*args, **kwargs):
        out = rand(*args, **kwargs)
        drawn[0] += out.numel()
        return out

    was = vae.training
    vae.train(train)
    torch.rand = counting
    try:
        with torch.no_grad():
            vae(data, eps=None, generator=torch.Generator(device=DEVICE).manual_seed(NESTED_SEED))
    finally:
        torch.rand = rand
        vae.train(was)
    return drawn[0]


def nested_cell(cell: str) -> dict:
    """One cell set up as the benchmark does: its untraced, traced and
    again untraced graph epochs with the stamp and nested-span launches,
    one traced replay's kernels and, for the transformer, the dropout draws
    of an eager forward (phase 19)."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import run as brun
    from benchmark import trace
    from scrubvae_torch.utils import profiling

    transformer = cell.startswith("transformer")
    su = brun.set_up(cell, NESTED_SEED, DEVICE)
    trainer, ds = su.trainer, su.ds
    rng = np.random.default_rng(NESTED_SEED)

    def epoch(rows: int = NESTED_STEPS) -> dict:
        launches = profiling.launch_stamp.launches, profiling.launch_nested.launches
        trainer.train_epoch(2, rng.integers(0, len(ds), (rows, trainer.batch_size)))
        got = (profiling.launch_stamp.launches, profiling.launch_nested.launches)
        return {k: (a - b) / rows for k, a, b in zip(("stamps", "nested"), got, launches)}

    def expect(what: str, got, want) -> None:
        if got != want:
            raise AssertionError(f"nested {cell}: {what} {got}, not {want}")

    nested = NESTED_PER_STEP if transformer else 0
    epoch()  # captures the untraced step
    expect("an untraced epoch a step", epoch(), {"stamps": 0, "nested": 0})
    trainer.set_tracing(True)
    expect("the recapturing traced epoch a step", epoch(), {"stamps": 10, "nested": nested})
    expect("a traced epoch of replays a step", epoch(), {"stamps": 10, "nested": nested})
    spans = trainer.spans
    ms, nested_ms = spans.ms_per_step(), spans.nested_ms_per_step()
    if transformer:
        expect("a traced epoch's nested charges", spans.nested_counts,
               {"attention": 12 * NESTED_STEPS, "feedforward": 8 * NESTED_STEPS})
        if not 0 < nested_ms["attention"] + nested_ms["feedforward"] < ms["encoder"] + ms["decoder"]:
            raise AssertionError(f"nested {cell}: attention and feed-forward {nested_ms} against the slots {ms}")
    else:
        expect("a traced epoch's nested charges", spans.nested_counts, {"attention": 0, "feedforward": 0})
    rows = rng.integers(0, len(ds), (1, trainer.batch_size))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train_epoch(2, rows)  # one replay
        torch.cuda.synchronize()
    names = [e["name"] for e in trace.from_profiler(prof) if e["device"]]
    kernels = {"span_stamp": sum("span_stamp" in n for n in names), "nested_span": sum("nested_span" in n for n in names)}
    expect("one traced replay's kernels", kernels, {"span_stamp": 10, "nested_span": nested})
    trainer.set_tracing(False)
    expect("an untraced epoch after tracing a step", epoch(), {"stamps": 0, "nested": 0})
    draws = None
    if transformer:
        data = ds.batch(torch.as_tensor(rows[0], device=DEVICE))
        draws = {"train": eager_draws(trainer.model.vae, data, True), "eval": eager_draws(trainer.model.vae, data, False)}
        expect("an eager forward's dropout draws", draws, {"train": NESTED_DRAWS_PER_STEP, "eval": 0})
    rec = {"cell": cell, "seed": NESTED_SEED, "steps": NESTED_STEPS, "draws": draws,
           "nested_per_step": nested, "replay_kernels": kernels, "slot_ms_per_step": ms,
           "nested_ms_per_step": nested_ms}
    trainer.release_graphs()
    del trainer, ds, su
    torch.cuda.empty_cache()
    log("nested cell: " + json.dumps(rec))
    return rec


def nested_phase(card: str) -> dict:
    """The nested spans of the three cells and the transformer's dropout
    draws (phase 19)."""
    rec = {cell: nested_cell(cell) for cell in NESTED_CELLS}
    log(f"nested phase ({card}): " + json.dumps(rec))
    return rec


NORM_SHAPE, NORM_RATE, NORM_SEED = (512, 51, 128), 0.1, 2_100_000_021
# widths past the cell's, each a path of the kernels the cell does not take:
# 130 the one-float chunks, 1000 the 16-byte chunks and 1001 the one-float
# chunks with a backward past 48 KB of shared memory, 3632 the most
# (``residual_norm.MAX_D``)
NORM_WIDTH_SHAPES = ((64, 51, 130), (16, 51, 1000), (16, 51, 1001), (8, 51, 3632))
NORM_SETS = 4  # input sets the timings cycle through: 4 x 43 MB and more, past the 50 MB L2
NORM_CELL_STEPS = 20
NORM_TAILS, NORM_ENCODER_TAILS = 20, 8  # 4 encoder layers x 2 and 4 decoder layers x 3


def _norm_inputs(gen: torch.Generator, masked: bool, shape=NORM_SHAPE) -> dict:
    from scrubvae_torch.models.transformer import LN_EPS

    B, L, d = shape
    return {
        "x": torch.randn(B, L, d, generator=gen, device=DEVICE),
        "y": torch.randn(B, L, d, generator=gen, device=DEVICE),
        "keep": torch.rand(B, L, d, generator=gen, device=DEVICE) < 1.0 - NORM_RATE if masked else None,
        "rate": NORM_RATE,
        "weight": 0.5 + torch.rand(d, generator=gen, device=DEVICE),
        "bias": torch.rand(d, generator=gen, device=DEVICE) - 0.5,
        "eps": LN_EPS,
    }


def _norm_run(fn, a: dict, g: torch.Tensor, dtype=torch.float32) -> dict:
    """``fn``'s output and its gradients in x, y, weight and bias for the
    output gradient ``g``, on copies of the inputs cast to ``dtype``."""
    leaves = {k: a[k].detach().to(dtype).requires_grad_() for k in ("x", "y", "weight", "bias")}
    out = fn(leaves["x"], leaves["y"], a["keep"], a["rate"], leaves["weight"], leaves["bias"], a["eps"])
    grads = torch.autograd.grad(out, list(leaves.values()), g.to(dtype))
    return {"out": out.detach(), **{"d" + k: v for k, v in zip(leaves, grads)}}


def norm_check(masked: bool, shape=NORM_SHAPE) -> dict:
    """The kernels against the plain version at ``shape`` (phase 20)."""
    from scrubvae_torch.ops import residual_norm as rn

    gen = torch.Generator(device=DEVICE).manual_seed(NORM_SEED + masked + shape[-1])
    a = _norm_inputs(gen, masked, shape)
    g = torch.randn(shape, generator=gen, device=DEVICE)
    launches = rn.residual_norm.launches, rn.residual_norm_grad.launches
    kernel = _norm_run(rn.residual_norm, a, g)
    again = _norm_run(rn.residual_norm, a, g)
    ran = (rn.residual_norm.launches - launches[0], rn.residual_norm_grad.launches - launches[1])
    plain = _norm_run(rn.residual_norm_reference, a, g)
    exact = _norm_run(rn.residual_norm_reference, a, g, torch.float64)
    torch.cuda.synchronize()
    rec = {"shape": list(shape), "masked": masked, "launches": ran,
           "repeats_bitwise": all(bits_equal(kernel[k], again[k]) for k in kernel)}
    bad = []
    if ran != (2, 4):
        bad.append(f"launches {ran}, not (2, 4)")
    if not rec["repeats_bitwise"]:
        bad.append("a second run differs")
    for k, ref in exact.items():
        scale = float(ref.abs().max())
        err_k = float((kernel[k].double() - ref).abs().max()) / scale
        err_p = float((plain[k].double() - ref).abs().max()) / scale
        gap = float((kernel[k] - plain[k]).abs().max())
        ulp = 2.0 ** (math.floor(math.log2(float(plain[k].abs().max()))) - 23)
        rec[k] = {"kernel_err": err_k, "plain_err": err_p, "gap": gap, "gap_ulps": gap / ulp}
        if not err_k <= 2 * err_p + 2.0 ** -22:
            bad.append(f"{k}: kernel error {err_k:.3g} against the plain version's {err_p:.3g}")
    if bad:
        raise AssertionError(f"norm check {rec}: {bad}")
    log("norm check: " + json.dumps(rec))
    return rec


def norm_cell(cell: str) -> dict:
    """Tail launches a step in a graph epoch of the cell as the benchmark
    sets it up, and in one eval forward (phase 20)."""
    from benchmark import run as brun
    from scrubvae_torch.ops import residual_norm as rn

    su = brun.set_up(cell, NORM_SEED, DEVICE)
    trainer, ds = su.trainer, su.ds
    rng = np.random.default_rng(NORM_SEED)

    def counts():
        return rn.residual_norm.launches, rn.residual_norm_grad.launches

    trainer.train_epoch(2, rng.integers(0, len(ds), (NORM_CELL_STEPS, trainer.batch_size)))  # captures
    before = counts()
    trainer.train_epoch(2, rng.integers(0, len(ds), (NORM_CELL_STEPS, trainer.batch_size)))
    step = [(b - a) / NORM_CELL_STEPS for a, b in zip(before, counts())]
    data = ds.batch(torch.as_tensor(rng.integers(0, len(ds), trainer.batch_size), device=DEVICE))
    vae = trainer.model.vae
    vae.eval()
    before = counts()
    with torch.no_grad():
        vae(data, eps=None)
    evals = [b - a for a, b in zip(before, counts())]
    vae.train()
    torch.cuda.synchronize()
    transformer = cell.startswith("transformer")
    want = ([NORM_TAILS, 2 * NORM_TAILS], [NORM_TAILS, 0]) if transformer else ([0, 0], [0, 0])
    rec = {"cell": cell, "per_step": step, "eval_forward": evals}
    if transformer:
        rec["export"] = norm_export(trainer.model, data)
    brun.free_program(su)
    if [step, evals] != list(want):
        raise AssertionError(f"norm {cell}: launches {rec}, not {want}")
    log("norm cell: " + json.dumps(rec))
    return rec


def norm_export(model, data: dict) -> dict:
    """The transformer's encoder exported on the card (``utils.export``):
    the trace and the artifact launch no tail kernel (an exported program
    runs the plain tails), and the artifact gives the eager encoder's
    outputs, whose tails are the kernels, within the serve phase's
    tolerance (phase 20)."""
    from scrubvae_torch.ops import residual_norm as rn
    from scrubvae_torch.utils.export import ENCODER_KEYS, export_encoder, load_exported

    def counts():
        return rn.residual_norm.launches, rn.residual_norm_grad.launches

    inputs = {k: data[k] for k in ENCODER_KEYS if k in data}
    before = counts()
    fn = load_exported(export_encoder(model, inputs))
    exported = [b - a for a, b in zip(before, counts())]
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            before = counts()
            got = fn(inputs)
            artifact = [b - a for a, b in zip(before, counts())]
            want = model.encode(inputs)
            eager = [b - a for a, b in zip(before, counts())]
    finally:
        model.train(was)
    rec = {"export_launches": exported, "artifact_launches": artifact, "eager_launches": eager,
           "max_abs_err": _serve_err("norm export", got, want, SERVE_TOL)}
    if [exported, artifact, eager] != [[0, 0], [0, 0], [NORM_ENCODER_TAILS, 0]]:
        raise AssertionError(f"norm export: launches {rec}, not 0, 0 and {NORM_ENCODER_TAILS} forward")
    return rec


def norm_timings() -> dict:
    """Device ms of a forward and of a backward at the cell's shape with a
    mask: the kernels, their bound, the plain version, ``F.layer_norm`` of
    the pre-added sum (phase 20)."""
    import torch.nn.functional as F

    from scrubvae_torch.ops import residual_norm as rn

    gen = torch.Generator(device=DEVICE).manual_seed(NORM_SEED + 7)
    sets = [_norm_inputs(gen, True) for _ in range(NORM_SETS)]
    grads = [torch.randn(NORM_SHAPE, generator=gen, device=DEVICE) for _ in range(NORM_SETS)]
    turn, held = [0], [None] * NORM_SETS

    def cycle(fn):
        # each call's outputs stay alive until its set comes round again,
        # so every call writes buffers other than the last few calls' (the
        # step's tails write fresh ones; rewriting one buffer would let the
        # L2 absorb the writes)
        def call():
            i = turn[0] = (turn[0] + 1) % NORM_SETS
            held[i] = fn(sets[i], grads[i], i)
        return call

    inv = float(np.float32(1.0) / np.float32(1.0 - NORM_RATE))
    stats = [rn._forward_launch(a["x"], a["y"], a["keep"], inv, a["weight"], a["bias"], a["eps"])[1] for a in sets]

    def plain(a, requires):
        leaves = [a[k].detach().requires_grad_(requires) for k in ("x", "y", "weight", "bias")]
        return leaves, rn.residual_norm_reference(leaves[0], leaves[1], a["keep"], a["rate"], *leaves[2:], a["eps"])

    plain_graphs = [plain(a, True) for a in sets]
    d = NORM_SHAPE[-1]
    lib_in = [[(a["x"] + torch.where(a["keep"], a["y"] / (1.0 - NORM_RATE), 0.0)).requires_grad_(),
               a["weight"].detach().requires_grad_(), a["bias"].detach().requires_grad_()] for a in sets]
    lib_graphs = [F.layer_norm(s, (d,), w, b, sets[0]["eps"]) for s, w, b in lib_in]
    n = sets[0]["x"].numel()
    nbytes = {"forward": 4 * n * 3 + n, "backward": 4 * n * 5 + n}
    rec = {
        "shape": list(NORM_SHAPE),
        "kernel_ms": {
            "forward": device_ms(cycle(lambda a, g, i: rn._forward_launch(
                a["x"], a["y"], a["keep"], inv, a["weight"], a["bias"], a["eps"]))),
            "backward": device_ms(cycle(lambda a, g, i: rn.residual_norm_grad(
                g, a["x"], a["y"], a["keep"], inv, a["weight"], stats[i]))),
        },
        "bound_ms": {k: v / HBM_BYTES_PER_S * 1e3 for k, v in nbytes.items()},
        "bound_mb": {k: v / 1e6 for k, v in nbytes.items()},
        "plain_ms": {
            "forward": device_ms(cycle(lambda a, g, i: plain(a, False)[1])),
            "backward": device_ms(cycle(lambda a, g, i: torch.autograd.grad(
                plain_graphs[i][1], plain_graphs[i][0], g, retain_graph=True))),
        },
        "library_ms": {
            "forward": device_ms(cycle(lambda a, g, i: F.layer_norm(
                lib_in[i][0].detach(), (d,), a["weight"], a["bias"], a["eps"]))),
            "backward": device_ms(cycle(lambda a, g, i: torch.autograd.grad(
                lib_graphs[i], lib_in[i], g, retain_graph=True))),
        },
    }
    rec["kernel_roofline_pct"] = {k: 100 * rec["bound_ms"][k] / rec["kernel_ms"][k] for k in nbytes}
    log("norm timings: " + json.dumps(rec))
    return rec


def norm_phase(card: str) -> dict:
    """The post-norm tail's kernels (phase 20)."""
    rec = {"check": [norm_check(True), norm_check(False)] + [norm_check(True, sh) for sh in NORM_WIDTH_SHAPES]}
    rec["cells"] = [norm_cell(c) for c in ("transformer.b512", "flagship.b512")]
    torch.cuda.empty_cache()
    rec["timings"] = norm_timings()
    log(f"norm phase ({card}): " + json.dumps(rec))
    return rec


def norm_record(norm: dict = None) -> dict:
    """The kernels line's record of the post-norm tail's kernels, from phase
    20 alone (its fields null where the phase did not run): launches a step
    of the transformer's graph epoch, forward and backward (0 on the
    flagship), the largest error of any check against the plain version
    in float64, and forward and backward device ms at the cell's shape
    beside the bound, the plain version's and ``F.layer_norm``'s."""
    rec = {
        "name": "residual_norm",
        "route": "cuda",
        "source": "scrubvae_torch/csrc/residual_norm.cu",
        "replaces": "none (XLA-fused in JAX)",
        "kernels": ["residual_norm_forward_kernel", "residual_norm_backward_kernel",
                    "residual_norm_weight_sum_kernel"],
    }
    fields = ("launches_per_step", "flagship_launches_per_step", "max_abs_err", "max_rel_err", "ms", "bound_ms",
              "bound_by", "plain_ms", "library_ms", "shape", "checked_shapes")
    outputs = ("out", "dx", "dy", "dweight", "dbias")
    if norm is None:
        return {**rec, **dict.fromkeys(fields)}
    cells = {c["cell"]: c for c in norm["cells"]}
    t = norm["timings"]
    return {
        **rec,
        "launches_per_step": dict(zip(("forward", "backward"), cells["transformer.b512"]["per_step"])),
        "flagship_launches_per_step": dict(zip(("forward", "backward"), cells["flagship.b512"]["per_step"])),
        "max_abs_err": max(c[k]["gap"] for c in norm["check"] for k in outputs),
        "max_rel_err": max(c[k]["kernel_err"] for c in norm["check"] for k in outputs),
        "ms": t["kernel_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "bytes",
        "plain_ms": t["plain_ms"],
        "library_ms": t["library_ms"],
        "shape": t["shape"],
        "checked_shapes": sorted({tuple(c["shape"]) for c in norm["check"]}),
    }


def kernels_line(kernel: dict, path: dict, fit: dict, full: dict, bench: dict, x360: dict, models: dict,
                 surface: dict = None, serve: dict = None, mesh: dict = None, graph: dict = None) -> dict:
    """One record per kernel of the main path: its launches on the path run
    and, at the fc_sigma shape, its time beside the plain version's, the
    bound and the library call's, for the f32 variant (where
    ``torch._fused_adamw_`` computes the same function) and for every
    variant; the Philox against the injected-noise time of the bf16
    variant; and the whole flagship pass (every leaf, one launch per
    variant) beside its bound and ``torch._fused_adamw_`` over f32 copies;
    and the full phase's launches, with the discriminator's inner pass (the
    f32 variant over its 22 leaves) beside its bound, the plain version's
    and ``torch._fused_adamw_``'s time; and the launches of the bench's run
    and of each x360, models and surface training run with its leaf tables'
    agreement with the plain version (the surface's sgd and unfused Adam
    runs launch it 0 times), and of the serve phase's training steps and
    its serving (0: exporting and serving train nothing); and the mesh
    phase's launches a step on each rank of each mesh and the shard launch
    path (each model rank's slice of ``fc_sigma`` at its element offset):
    its time beside its bound, the plain version's and
    ``torch._fused_adamw_``'s; and the graph phase's launches a step of the
    graph epochs (counted from the replays) and the kernel replayed in a
    graph (bitwise at steps 1 to 3, its replayed pass's time beside the
    eager call's). ``max_abs_err`` is the largest of every check's."""
    errs = [kernel["max_abs_err"]]
    errs += [] if full is None else [full["inner_adamw"]["max_abs_err"]]
    errs += [] if x360 is None else [r["kernel_max_abs_err"] for r in x360["runs"].values()]
    errs += [] if models is None else [r["kernel_max_abs_err"] for r in models["runs"].values()]
    surface_runs, surface_sets = {}, {}
    if surface is not None:
        surface_runs = {
            "parkinsons": surface["parkinsons"]["per_key"], "parkinsons_raw_pose": surface["parkinsons"]["raw_pose"],
            "host_stream": surface["host_stream"]["host_stream_run"],
            "device_resident": surface["host_stream"]["device_run"], **surface["optimizers_prior"],
            **{f"bench_{k}": v for k, v in surface["bench"].items()},
        }
        surface_sets = {
            "parkinsons": surface["parkinsons"]["per_key"]["leaf_set"],
            "low_rank": surface["bench"]["sigma_rank"]["leaf_set"],
            "beta_prior": surface["optimizers_prior"]["beta_prior"]["leaf_set"],
        }
        errs += [c["max_abs_err"] for c in surface_sets.values()]
    shards = [] if mesh is None else [sh for m in mesh["meshes"].values() for sh in m["shards"]]
    errs += [sh["max_abs_err"] for sh in shards]
    errs += [] if graph is None else [graph["kernel"]["max_abs_err"]]
    f32 = kernel["timings"]["w f32, m f32"]
    bf16 = kernel["timings"]["w bf16, m bf16"]
    leaf_set = kernel["leaf_set"]
    return {"kernels": [{
        "name": "fused_adamw",
        "route": "cuda",
        "source": "scrubvae_torch/csrc/fused_adamw.cu",
        "replaces": "scrubvae_tpu/ops/fused_adamw.py:77",
        "launches": path["kernel_launches"],
        "max_abs_err": max(errs),
        "ms": f32["kernel_ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
        "shape": list(KERNEL_SHAPES[0][1]),
        "variant": "w f32, m f32",
        "variants": {
            v: {k: t[k] for k in ("kernel_ms", "plain_ms", "bound_ms", "bytes")}
            for v, t in kernel["timings"].items()
        },
        "main_path_fc_sigma_variant": "w bf16, m bf16",
        "philox_ms": bf16["kernel_ms"],
        "inject_ms": bf16["inject_ms"],
        "inject_bound_ms": bf16["inject_bound_ms"],
        "pass_ms": leaf_set["pass_ms"],
        "pass_bound_ms": leaf_set["pass_bound_ms"],
        "pass_library_ms": leaf_set["pass_library_ms"],
        "pass_plain_ms": leaf_set["pass_plain_ms"],
        "pass_device_ms": leaf_set["pass_device_ms"],
        "launches_per_step": path["launches_per_step"],
        "fit_launches": None if fit is None else fit["optimizer_launches"],
        "fit_launches_per_step": None if fit is None else fit["launches_per_step"],
        "full_launches": None if full is None else full["kernel_launches"],
        "full_launches_per_step": None if full is None else full["launches_per_step"],
        "full_inner_launches_per_step": None if full is None else full["inner_launches_per_step"],
        "bench_launches": None if bench is None else bench["optimizer_launches"],
        "bench_launches_per_step": None if bench is None else bench["launches_per_step"],
        "x360_launches": None if x360 is None else {k: r["optimizer_launches"] for k, r in x360["runs"].items()},
        "x360_launches_per_step": None if x360 is None else {k: r["launches_per_step"] for k, r in x360["runs"].items()},
        "x360_max_abs_err": None if x360 is None else {k: r["kernel_max_abs_err"] for k, r in x360["runs"].items()},
        "models_launches": None if models is None else {k: r["optimizer_launches"] for k, r in models["runs"].items()},
        "models_launches_per_step": None if models is None else {k: r["launches_per_step"] for k, r in models["runs"].items()},
        "models_max_abs_err": None if models is None else {k: r["kernel_max_abs_err"] for k, r in models["runs"].items()},
        "surface_launches_per_step": {k: r["launches_per_step"] for k, r in surface_runs.items()} or None,
        "serve_train_launches_per_step": None if serve is None else serve["trained_run"]["launches_per_step"],
        "serve_serving_launches": None if serve is None else serve["trained_run"]["serving_launches"],
        "surface_leaf_sets": {
            k: {f: c[f] for f in LEAF_SET_KEYS + ("max_abs_err", "bytes")} for k, c in surface_sets.items()
        } or None,
        "mesh_launches_per_step_per_rank": None if mesh is None else {
            k: m["launches_per_step_per_rank"] for k, m in mesh["meshes"].items()
        },
        "mesh_shard_path": None if not shards else [
            {k: sh[k] for k in ("shape", "whole_shape", "start", "variant", "bitwise_plain", "bitwise_whole_leaf_rows",
                                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "bytes")}
            for sh in mesh["meshes"]["model2"]["shards"]
        ],
        "graph_launches_per_step": None if graph is None else {
            k: graph[k]["launches_per_step"] for k in ("flagship", "5_full")
        },
        "graph_replay": None if graph is None else graph["kernel"],
        "inner_pass": None if full is None else {
            k: full["inner_adamw"][k]
            for k in (
                "leaves", "elements", "kernel_ms", "kernel_call_ms", "plain_ms", "plain_call_ms", "bound_ms",
                "bound_by", "library_ms", "library_call_ms", "max_abs_err",
            )
        },
    }]}


def timed(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its wall seconds logged as phase ``name``'s."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--phases", default=",".join(PHASES),
        help="comma-separated phases out of %s (default: %s)"
        % (",".join(PHASES + ("profile",)), ",".join(PHASES)),
    )
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    # cuBLAS is deterministic with this workspace setting; the parity phase
    # asks for deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from scrubvae_torch.ops import fused_adamw as fa

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    log(smi[0] if smi else "nvidia-smi: no output")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from scrubvae_torch.ops import residual_norm as rn

    for name, mod in (("fused_adamw", fa), ("residual_norm", rn)):
        t0 = time.perf_counter()
        lib = mod.build(force=True)
        log(f"build {name}: {time.perf_counter() - t0:.2f} s -> {lib.relative_to(ROOT)}")
        log(lib.with_suffix(".ptxas.txt").read_text().strip())

    flagship = None
    if {"kernel", "path", "profile"} & set(phases):
        from scrubvae_torch import bench

        flagship = bench.build(512, 51, 128, bench.FULL_CH, DEVICE)
    kernel = timed("kernel", kernel_phase, flagship[0]) if "kernel" in phases else None
    if "parity" in phases:
        timed("parity", parity_phase)
    path = None
    if "path" in phases or "profile" in phases:
        path, rows, loss_scale = timed("path", path_phase, *flagship)
        if "profile" in phases:
            profile_phase(flagship[0], rows, loss_scale)
    flagship = None  # frees the path phase's trainer before the fit phase
    torch.cuda.empty_cache()
    if "profile" in phases:
        timed("profile", profile_configs)
    card = smi[0] if smi else "nvidia-smi: no output"
    analysis_tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_analysis_"))
    try:
        keep = analysis_tmp / "fit_run" if "analysis" in phases else None
        fit = timed("fit", fit_phase, card, keep=keep) if "fit" in phases else None
        torch.cuda.empty_cache()
        full = timed("full", full_phase, card) if "full" in phases else None
        torch.cuda.empty_cache()
        bench = timed("bench", bench_phase) if "bench" in phases else None
        torch.cuda.empty_cache()
        x360 = timed("x360", x360_phase, card) if "x360" in phases else None
        torch.cuda.empty_cache()
        models = timed("models", models_phase, card) if "models" in phases else None
        torch.cuda.empty_cache()
        surface = timed("surface", surface_phase, card) if "surface" in phases else None
        torch.cuda.empty_cache()
        if "analysis" in phases:
            timed("analysis", analysis_phase, card, analysis_tmp)
        torch.cuda.empty_cache()
        serve = timed("serve", serve_phase, card) if "serve" in phases else None
        torch.cuda.empty_cache()
        mesh = timed("mesh", mesh_phase, card) if "mesh" in phases else None
        torch.cuda.empty_cache()
        graph = timed("graph", graph_phase, card) if "graph" in phases else None
        torch.cuda.empty_cache()
        if "spans" in phases:
            timed("spans", spans_phase, card)
        torch.cuda.empty_cache()
        if "solves" in phases:
            timed("solves", solves_phase, card)
        torch.cuda.empty_cache()
        if "nested" in phases:
            timed("nested", nested_phase, card)
        torch.cuda.empty_cache()
        norm = timed("norm", norm_phase, card) if "norm" in phases else None
    finally:
        shutil.rmtree(analysis_tmp, ignore_errors=True)
    records = []
    if kernel is not None and path is not None:
        records = kernels_line(kernel, path, fit, full, bench, x360, models, surface, serve, mesh, graph)["kernels"]
    if records or norm is not None:
        log(json.dumps({"kernels": records + [norm_record(norm)]}))
    log(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
