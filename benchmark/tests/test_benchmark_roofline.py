"""The optimizer pass's byte count against the leaf shapes and dtypes."""

import pytest
import torch

from benchmark import manifest, roofline
from benchmark.reference import data as rdata
from benchmark.reference import model as rm


def leaf_numels(config):
    s = manifest.sections(config, 512)
    skel = rdata.load_skeleton(manifest.SKELETON)
    with torch.device("meta"):
        m = rm.build(dict(s["model"]), s["disentangle"], s["loss"].keys(), skel.n_keypts, s["data"]["arena_size"],
                     {"ids": 4})
    return [p.numel() for p in m.parameters()], s["train"]


def test_per_leaf_bytes():
    assert roofline.leaf_dtype_bytes(1 << 16, {"param_dtype": "bf16"}) == (2, 2)
    assert roofline.leaf_dtype_bytes((1 << 16) - 1, {"param_dtype": "bf16"}) == (4, 4)
    assert roofline.leaf_dtype_bytes(1 << 20, {}) == (4, 2)
    assert roofline.leaf_dtype_bytes(1 << 20, {"moment_dtype": "f32"}) == (4, 4)
    # w and g read, w written; m and n read and written
    assert roofline.adamw_bytes([10], {"moment_dtype": "f32"}) == 10 * (3 * 4 + 4 * 4)


def test_dtype_groups():
    assert roofline.dtype_group(1 << 16, {"param_dtype": "bf16"}) == "bf16/bf16"
    assert roofline.dtype_group(1 << 16, {}) == "f32/bf16"
    assert roofline.dtype_group(100, {"param_dtype": "bf16"}) == "f32/f32"


def test_pass_seconds_sums_each_pass_and_takes_the_median():
    # two launches a pass, microseconds
    ev = [{"start": s, "end": s + d} for s, d in [(0, 100), (110, 50), (1000, 120), (1130, 60), (2000, 90), (2100, 40)]]
    assert roofline.pass_seconds(ev, 3) == pytest.approx(150e-6)
    assert roofline.pass_seconds(ev[:5], 3) is None
    assert roofline.pass_seconds([], 3) is None


@pytest.mark.parametrize("config,expected", [
    # the flagship's: the port's leaf table holds the same 752,851,792 bytes
    ("flagship", 752_851_792),
    # full5 stores every leaf in f32 (its yaml sets no param_dtype)
    ("full5", 1_069_906_768),
])
def test_configuration_bytes(config, expected):
    numels, train = leaf_numels(config)
    assert len(numels) == 130 and sum(numels) == 53_308_812
    assert roofline.adamw_bytes(numels, train) == expected
