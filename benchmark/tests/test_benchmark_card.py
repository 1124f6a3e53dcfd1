"""The run's own refusals, and a short run of each cell on the card."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import manifest

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _run(cwd, *args, env=None):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args], cwd=cwd, capture_output=True, text=True,
                          timeout=900, env=env)


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, "--workload", "flagship.b512", "--seed", "1", "--seconds", "1", "--trace", "0", env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_fails_without_the_measured_package(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("from benchmark import compare, run; run.run_cell('flagship.b512', 1, 0.1, False, device='cpu', small=True, "
            "limits=dict.fromkeys(compare.NUMBERS, 1))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "scrubvae_torch" in out.stderr


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in manifest.benchmark()["workloads"]])
def test_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = _run(ROOT, "--workload", cell, "--seed", str(2**31 + 3), "--seconds", "3", "--trace", "1")
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], out.stderr[-3000:]
    assert result["device"]["busy_s"] > 0
