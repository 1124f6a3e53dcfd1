"""Host streaming (``data.host_stream``), the port against itself and the
JAX package: the frame store in host memory, a batch's frames gathered
into a window-major slab, streamed to the device and assembled there.

- Slab batches bitwise against the device-resident ``StreamDataset.batch``
  of the same indices, extras included; the slab's layout and raw fields
  bitwise against JAX's ``HostStreamDataset.host_batch``, its computed
  fields and the assembled batch within the port-against-JAX tolerance of
  ``tests/test_torch_port_x360.py``. A slab laid out frame-major (a planted
  fault) fails the bitwise check.
- ``prefetch_to_device``: the items in order, and an exception on the
  worker re-raised at the consumer.
- A host-streamed val split is refused.
- ``Trainer`` on the host-streamed train split against the device-resident
  one from the same seed over 2 epochs: the same batch order, the losses
  and the weights bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrubvae_tpu.data.dataset import StreamDataset as JaxStreamDataset
from scrubvae_tpu.data.hoststream import HostStreamDataset as JaxHostStreamDataset
from scrubvae_tpu.data.pipeline import build_frame_store as jax_build_frame_store
from scrubvae_torch import bench, factory
from scrubvae_torch.data.dataset import StreamDataset
from scrubvae_torch.data.hoststream import HostStreamDataset, prefetch_to_device
from scrubvae_torch.data.pipeline import build_frame_store
from scrubvae_torch.train.trainer import Trainer
from test_torch_port_x360 import JSKEL, SKEL, burst_stream, f64_noise

torch.set_num_threads(1)

KEYS = ("x6d", "root", "offsets", "target_pose", "avg_speed_3d", "heading", "ids", "raw_pose")
IDX = np.asarray([0, 5, 17, 41, 3, 29, 11, 2])


def _close(a: np.ndarray, b: np.ndarray, key: str, noise: float = 0.0) -> None:
    length = np.linalg.norm(b, axis=-1, keepdims=True) if key in ("root", "raw_pose", "pose") else 0.0
    assert (np.abs(a - b) <= 1e-5 + 2 * noise + 2e-6 * length).all(), (key, np.abs(a - b).max())


@pytest.fixture(scope="module")
def pair():
    """The port's device-resident dataset and its host-streamed twin, with
    a per-window extra, and JAX's two."""
    pose, ids = burst_stream()
    ts = build_frame_store(pose, ids, SKEL, window=51, stride=2, device="cpu")
    js = jax_build_frame_store(pose, ids, JSKEL, window=51, stride=2)
    mid = ts.ids[ts.starts + 25].numpy()
    extra = {"ids": mid, "fluorescence": (mid[:, None] * 1.5 + 0.25).astype(np.float32)}
    keys = KEYS + ("fluorescence",)
    tds = StreamDataset(ts, SKEL, keys, "midfwd", arena_size=bench.ARENA, discrete_classes={"ids": np.unique(mid)},
                        device="cpu", extras=extra)
    jds = JaxStreamDataset(js, JSKEL, keys, "midfwd", arena_size=bench.ARENA, discrete_classes={"ids": np.unique(mid)},
                           extras={k: jnp.asarray(v) for k, v in extra.items()})
    return tds, HostStreamDataset.from_stream(tds), jds, JaxHostStreamDataset.from_stream(jds)


def _noise(tds, jds) -> dict:
    """JAX's float64 distance of the per-frame x6d and zero-root FK, under
    the slab's and the batch's names."""
    n = f64_noise(tds.store, jds.store, {"x6d_enc": np.zeros(())}, "midfwd")
    return {"x6d": n["x6d"], "target_pose": n["target_pose"], "tpose": n["target_pose"]}


def test_slab_batches_are_bitwise_the_device_resident_ones(pair):
    tds, hds = pair[:2]
    want = tds.batch(torch.as_tensor(IDX))
    got = hds.make_batch_fn()(hds.host_batch(IDX))
    assert set(got) == set(want) == set(tds.data_keys)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    via_batch = hds.batch(torch.as_tensor(IDX))
    assert all(torch.equal(via_batch[k], want[k]) for k in want)


def test_frame_major_slab_fails_the_bitwise_check(pair):
    """A planted fault: the slab's rows frame-major (row w*B + i holds frame
    starts[i] + w), which the window-major assembler misreads."""
    tds, hds = pair[:2]
    slab = hds.host_batch(IDX)
    B, W = len(IDX), hds.store.window
    planted = {
        k: v.reshape(B, W, *v.shape[1:]).transpose(0, 1).reshape(v.shape) if not k.startswith("extra_") else v
        for k, v in slab.items()
    }
    want = tds.batch(torch.as_tensor(IDX))
    got = hds.make_batch_fn()(planted)
    assert not all(torch.equal(got[k], want[k]) for k in ("x6d", "root", "target_pose"))


def test_slab_against_jax(pair):
    """The slab's layout and its raw fields bitwise as JAX's, the fields
    computed per frame within tolerance; JAX's assembled batch too."""
    tds, hds, jds, jhds = pair
    noise = _noise(tds, jds)
    slab, jslab = hds.host_batch(IDX), jhds.host_batch(IDX)
    assert set(slab) == set(jslab)
    for k in ("pose", "ids", "extra_ids", "extra_fluorescence"):
        np.testing.assert_array_equal(slab[k].numpy(), np.asarray(jslab[k]).astype(slab[k].numpy().dtype), err_msg=k)
    for k in ("offsets", "yaw", "x6d", "tpose"):
        _close(slab[k].numpy(), np.asarray(jslab[k]), k, noise.get(k, 0.0))
    want = jhds.batch(IDX)
    got = hds.batch(IDX)
    for k in want:
        _close(got[k].numpy().astype(np.float64), np.asarray(want[k]).astype(np.float64), k, noise.get(k, 0.0))


def test_prefetch_keeps_order_and_values(pair):
    hds = pair[1]
    batches = [np.arange(i, i + 4) for i in range(0, 20, 4)]
    stats = {}
    got = list(prefetch_to_device(hds.epoch_slabs(batches), size=2, device="cpu", stats=stats))
    assert len(got) == len(batches) == stats["items"] and stats["wait_s"] >= 0.0
    # the worker's gather and copy issue are timed; device copy times only on CUDA
    assert stats["gather_s"] > 0.0 and stats["issue_s"] >= 0.0 and "copy_ms" not in stats
    for idx, slab in zip(batches, got):
        ref = hds.host_batch(idx)
        assert all(torch.equal(slab[k], ref[k]) for k in ref)


def test_worker_exception_reraises_at_the_consumer():
    def items():
        yield {"a": torch.zeros(2)}
        raise RuntimeError("slab gather failed")

    it = prefetch_to_device(items(), size=2, device="cpu")
    assert torch.equal(next(it)["a"], torch.zeros(2))
    with pytest.raises(RuntimeError, match="slab gather failed"):
        next(it)


def test_consumer_leaving_early_stops_the_worker():
    it = prefetch_to_device(({"a": torch.full((2,), float(i))} for i in range(100)), size=2, device="cpu")
    next(it)
    it.close()  # joins the worker; a hang here is the fault


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _trainer(train_ds, val_ds=None) -> Trainer:
    cfg = bench.bench_config(8, 51, 8, bench.SMALL_CH, False, precision="fp32")
    model, info = factory.build_model(cfg["model"], cfg["disentangle"], 18, "midfwd", arena_size=bench.ARENA,
                                      discrete_classes=train_ds.discrete_classes, loss_keys=cfg["loss"].keys(),
                                      device="cpu")
    datasets = {"train": train_ds} if val_ds is None else {"train": train_ds, "val": val_ds}
    return Trainer(cfg, datasets, model, info, device="cpu")


def test_host_streamed_val_split_is_refused(pair):
    tds, hds = pair[:2]
    with pytest.raises(ValueError, match="host-streaming val splits"):
        _trainer(tds, hds)


def test_trainer_host_stream_is_bitwise_the_device_resident_run(pair):
    tds, hds = pair[:2]
    small = dataclasses.replace(tds, data_keys=bench.KEYS)
    runs = {}
    for label, ds in (("device", small), ("host", HostStreamDataset.from_stream(small))):
        trainer = _trainer(ds)
        assert trainer.host_stream is (label == "host")
        losses = [trainer.train_epoch(e) for e in (1, 2)]
        runs[label] = (losses, [p.detach().clone() for p in trainer.model.parameters()], trainer)
    assert runs["host"][0] == runs["device"][0]
    assert all(torch.equal(a, b) for a, b in zip(runs["host"][1], runs["device"][1]))
    assert runs["host"][2].stream_stats["items"] == 2 * runs["host"][2].steps_per_epoch
