"""The port's bench entry, ``python -m scrubvae_torch.bench``, on the CPU at
``--small`` size: its one JSON line, that it leaves the JAX bench's
``BENCH_BASELINE.json`` as it was, its flags, the card table,
and its FLOP count against a hand count from the layer shapes.

The hand count follows the bench's convention (2*M*N*K per product, as
autograd runs them): every convolution and dense layer once forward and
twice backward (the input and the weight gradient), but once backward for
a layer whose input needs no gradient (the first convolution); the 3x3
products of the forward kinematics in the jpe loss, 17 joints a frame,
``Rg @ R`` forward and twice backward and ``Rg @ offset`` forward and once
backward (the offsets need no gradient). What is left, the scrubbers'
small products (the linear projection, MALS's sums), is under 0.1% of the
step.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from scrubvae_torch import bench
from scrubvae_torch.models.layers import Conv1d, ConvTranspose1d, Linear

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SMALL = ["--small", "--device", "cpu", "--steps", "2", "--warmup", "1"]
KEYS = (
    "metric", "value", "unit", "step_ms", "device_kind", "param_dtype", "sigma_head_rank",
    "gflops_per_step", "tflops_per_s", "bytes_per_step", "bytes_accessed_gb_per_s", "bound_ms_per_step",
)


@pytest.fixture(scope="module")
def cli():
    baseline = ROOT / "BENCH_BASELINE.json"
    before = baseline.read_bytes() if baseline.exists() else None
    res = subprocess.run(
        [sys.executable, "-m", "scrubvae_torch.bench", *SMALL],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    after = baseline.read_bytes() if baseline.exists() else None
    return res, before, after


def test_prints_one_json_line(cli):
    res, _, _ = cli
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, res.stdout
    out = json.loads(lines[0])
    assert set(KEYS) <= set(out)
    assert out["metric"] == "train_samples_per_sec_per_chip" and out["unit"] == "samples/sec/chip"
    assert (out["device_kind"], out["param_dtype"], out["sigma_head_rank"]) == ("cpu", "f32", None)
    assert np.isfinite(out["total"]) and out["value"] > 0 and out["step_ms"] > 0
    np.testing.assert_allclose(out["value"], out["batch"] / out["step_ms"] * 1e3, rtol=1e-9)
    np.testing.assert_allclose(out["tflops_per_s"], out["gflops_per_step"] / out["step_ms"], rtol=1e-9)
    # no TPU baseline, and no card peak on the CPU
    assert not {"vs_baseline", "mfu", "peak_tflops", "peak_hbm_gb_per_s"} & set(out)


def test_leaves_the_jax_baseline_alone(cli):
    _, before, after = cli
    assert before == after


@pytest.mark.parametrize("flag", [["--no-fused"], ["--sigma-rank", "4"], ["--host-stream"]])
def test_flags_run(flag):
    """Each of the JAX bench's three flags runs the small bench and says so
    in its record: the unfused Adam, the low-rank head (rank 4 below the
    small model's 128 and 136), the host-streamed train split."""
    from scrubvae_torch.data.hoststream import HostStreamDataset
    from scrubvae_torch.train import optim

    args = bench.parse_args(SMALL + flag)
    out = bench.run(args)
    assert np.isfinite(out["total"]) and out["step_ms"] > 0
    assert out["fused_optimizer"] is (flag[0] != "--no-fused")
    assert out["sigma_head_rank"] == (4 if flag[0] == "--sigma-rank" else None)
    assert out.get("host_stream", False) is (flag[0] == "--host-stream")
    trainer, ds = bench.build(16, 51, 16, bench.SMALL_CH, "cpu", precision="fp32", bf16_params=False,
                              fused=not args.no_fused, sigma_rank=args.sigma_rank, host_stream=args.host_stream)
    assert isinstance(trainer.tx, optim.AdamLowp if args.no_fused else optim.FusedAdamW)
    assert isinstance(ds, HostStreamDataset) is args.host_stream
    assert hasattr(trainer.model.vae.encoder, "fc_sigma_u") is bool(args.sigma_rank)


def test_no_fused_needs_f32_params():
    """bf16 storage needs the fused optimizer, as the JAX trainer says."""
    with pytest.raises(SystemExit):
        bench.parse_args(["--no-fused"])
    assert bench.parse_args(["--no-fused", "--f32-params"]).no_fused


@pytest.mark.parametrize("flag", [["--batch", "64"], ["--z_dim", "32"]])
def test_small_refuses_batch_and_z(flag):
    """``--small`` fixes batch and z at 16; asking for others is an error,
    not a run at another size than the one asked for."""
    with pytest.raises(SystemExit):
        bench.parse_args(SMALL + flag)
    args = bench.parse_args(flag)
    assert (args.batch, args.z_dim) == ((64, 128) if flag[0] == "--batch" else (512, 32))


@pytest.mark.parametrize(
    "name,peak",
    [("NVIDIA H100 80GB HBM3", (989.4, 3350.0)), ("NVIDIA H100 PCIe", (756.0, 2000.0)), ("NVIDIA A100-SXM4-80GB", (None, None))],
)
def test_peak_specs(name, peak):
    assert bench.peak_specs(name) == peak


def hand_count(trainer, rows) -> int:
    """2*M*N*K over the model's convolutions and dense layers (from the
    shapes they see in one step) and the forward kinematics of the jpe
    loss."""
    layers = []

    def hook(module, inputs, output):
        x = inputs[0]
        if isinstance(module, Linear):
            fwd = 2 * x.shape[0] * module.in_features * module.out_features
        else:
            c_out, c_in, k = module.weight.shape
            length = x.shape[-1] if isinstance(module, ConvTranspose1d) else output.shape[-1]
            fwd = 2 * x.shape[0] * length * c_out * c_in * k
        layers.append(fwd * (3 if x.requires_grad else 2))

    handles = [
        m.register_forward_hook(hook) for m in trainer.model.modules() if isinstance(m, (Conv1d, ConvTranspose1d, Linear))
    ]
    try:
        trainer.train_epoch(1, rows)
    finally:
        for h in handles:
            h.remove()
    frames = rows.shape[1] * trainer.info["window"]
    joints = trainer.train_ds.n_keypts - 1
    fk = frames * joints * (3 * 2 * 27 + 2 * 2 * 9)
    return sum(layers) + fk


def test_flop_count_matches_a_hand_count():
    """``run``'s count of one step against the hand count of the same
    step, built as ``run`` builds it."""
    trainer, _ = bench.build(
        16, 51, 16, bench.SMALL_CH, torch.device("cpu"), precision="fp32", bf16_params=False
    )
    want = hand_count(trainer, np.zeros((1, 16), np.int64))
    out = bench.run(bench.parse_args(SMALL))
    got = out["gflops_per_step"] * 1e9
    print(f"bench {got:.0f} FLOPs a step, hand count {want}, rest {got - want:.0f}")
    assert want <= got <= want * 1.001
