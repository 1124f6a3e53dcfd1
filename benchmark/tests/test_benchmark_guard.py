"""The loaded-module check: top-level names compared whole."""

import subprocess
import sys

from benchmark import guard


def test_top_level_names_compared_whole():
    assert guard.forbidden_loaded(["scrubvae_torch", "scrubvae_torch.train", "jaxtyping", "optax_like.x"]) == []
    assert guard.forbidden_loaded(["jax.numpy", "flax.linen", "numpy"]) == ["flax", "jax"]
    assert guard.forbidden_loaded(["scrubvae_tpu.models", "jaxlib", "optax"]) == ["jaxlib", "optax", "scrubvae_tpu"]


def test_a_run_loads_none_of_them():
    code = (
        "import sys; from benchmark import compare, run, guard; "
        "run.run_cell('flagship.b512', 3, 0.1, False, device='cpu', small=True, "
        "limits=dict.fromkeys(compare.NUMBERS, 1)); "
        "print(guard.forbidden_loaded())"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
