"""A frame store in host memory, streamed to the device a batch at a time
(counterpart of ``host_store``, ``HostStreamDataset`` and
``prefetch_to_device`` of ``scrubvae_tpu/data/hoststream.py``).

For corpora larger than device memory (``data.host_stream: true``, train
split only): the frame store stays in host memory, pinned when the
dataset feeds a CUDA device, and for each batch the frames its windows
touch are gathered into a *slab*, copied to the device while the previous
step computes, and assembled there by the same ``assemble_windows`` as
the device-resident path.

* The slab is window-major: row ``i*W + w`` holds frame ``starts[i] + w``,
  so a slab-backed ``FrameStore`` with starts ``arange(B) * W`` assembles
  the same windows, bit for bit, as the device-resident store does for
  the batch's own starts.
* ``prefetch_to_device`` runs the gather and the host-to-device copy of
  slab t+1 on a worker thread and a side CUDA stream while step t
  computes; the consumer's stream waits on the copy's event, and every
  slab tensor is recorded on the consumer's stream, so the caching
  allocator reuses none of them while a step still reads it. An exception
  on the worker re-raises at the consumer.
* Per-window ``extras`` ride in the slab under ``extra_*`` keys.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from scrubvae_torch.data.pipeline import FrameStore, assemble_windows
from scrubvae_torch.data.skeleton import Skeleton
from scrubvae_torch.device import resolve_device

__all__ = ["HostStreamDataset", "host_store", "prefetch_to_device"]

# FrameStore fields gathered per frame into the slab
FRAME_FIELDS = ("pose", "local_quat", "offsets", "yaw", "ids", "x6d", "tpose")


def _host(t: torch.Tensor, pin: bool) -> torch.Tensor:
    t = t.detach().to("cpu", copy=True)
    return t.pin_memory() if pin else t


def host_store(store: FrameStore, pin: bool = True) -> FrameStore:
    """``store`` with every tensor moved to host memory, pinned when
    ``pin`` (pinning needs CUDA)."""
    return dataclasses.replace(
        store,
        **{f: _host(getattr(store, f), pin) for f in FRAME_FIELDS + ("starts",)},
        norm_params={k: {s: _host(a, pin) for s, a in v.items()} for k, v in store.norm_params.items()},
    )


@dataclasses.dataclass
class HostStreamDataset:
    """``StreamDataset``'s twin with its frame store in host memory.
    ``host_batch`` gathers a batch's slab on the host; ``make_batch_fn``
    returns the slab -> batch assembler that the train step runs on the
    device; ``batch(idx)`` does both, for callers that hold indices.
    ``device`` is where slabs go."""

    store: FrameStore  # host tensors (host_store)
    skeleton: Skeleton
    data_keys: Sequence[str]
    direction_process: str
    arena_size: Optional[np.ndarray]
    discrete_classes: Optional[Dict[str, np.ndarray]] = None
    device: object = "cuda"
    label: str = "train"
    extras: Optional[Dict[str, torch.Tensor]] = None  # per-window host tensors

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._pin = self.device.type == "cuda"
        self.extras = {k: _host(torch.as_tensor(v), self._pin) for k, v in (self.extras or {}).items()}

    def __len__(self) -> int:
        return int(self.store.starts.shape[0])

    @classmethod
    def from_stream(cls, ds) -> "HostStreamDataset":
        """A device-resident ``StreamDataset`` with its store and extras
        moved to host memory; the same metadata and target device."""
        pin = ds.device.type == "cuda"
        return cls(
            store=host_store(ds.store, pin=pin),
            skeleton=ds.skeleton,
            data_keys=tuple(ds.data_keys),
            direction_process=ds.direction_process,
            arena_size=ds.arena_size,
            discrete_classes=ds.discrete_classes,
            device=ds.device,
            label=ds.label,
            extras=dict(ds.extras or {}),
        )

    @property
    def n_keypts(self) -> int:
        return self.skeleton.n_keypts

    @property
    def kinematic_tree(self):
        return self.skeleton.tree

    @property
    def norm_params(self):
        return self.store.norm_params

    def _extra_keys(self) -> tuple:
        return tuple(k for k in self.extras if k in self.data_keys)

    # -- host side ---------------------------------------------------------

    def host_batch(self, idx) -> Dict[str, torch.Tensor]:
        """The slab of the windows whose dataset indices are ``idx``: each
        frame field flattened window-major to (B*W, ...), each extra
        gathered per window; into pinned memory when the target is CUDA."""
        idx = torch.as_tensor(np.asarray(idx)).long()
        W = int(self.store.window)
        fidx = (self.store.starts[idx][:, None] + torch.arange(W)).reshape(-1)

        def gather(src: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
            out = torch.empty((len(rows),) + tuple(src.shape[1:]), dtype=src.dtype, pin_memory=self._pin)
            return torch.index_select(src, 0, rows, out=out)

        slab = {f: gather(getattr(self.store, f), fidx) for f in FRAME_FIELDS}
        for k in self._extra_keys():
            slab["extra_" + k] = gather(self.extras[k], idx)
        return slab

    def epoch_slabs(self, batches: Iterable) -> Iterator[Dict[str, torch.Tensor]]:
        for idx in batches:
            yield self.host_batch(idx)

    # -- device side -------------------------------------------------------

    def make_batch_fn(self):
        """The slab -> batch assembler: a slab-backed ``FrameStore`` with
        starts ``arange(B) * W`` through ``assemble_windows``, then the
        extras."""
        W = int(self.store.window)
        tree = self.skeleton.tree
        dev = self.device
        norm_params = {k: {s: a.to(dev) for s, a in v.items()} for k, v in self.store.norm_params.items()}
        extra_keys = self._extra_keys()
        assemble_keys = tuple(k for k in self.data_keys if k not in self.extras)
        dp = self.direction_process
        pcs = self.store.part_centered_speed

        def fn(slab: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            B = slab["yaw"].shape[0] // W
            starts = torch.arange(B, device=slab["yaw"].device) * W
            store = FrameStore(
                **{f: slab[f] for f in FRAME_FIELDS},
                starts=starts, window=W, norm_params=norm_params, part_centered_speed=pcs,
            )
            out = assemble_windows(store, tree, starts, assemble_keys, dp)
            for k in extra_keys:
                out[k] = slab["extra_" + k]
            return out

        return fn

    def batch(self, idx) -> Dict[str, torch.Tensor]:
        """The batch of ``idx``, assembled on the device from its slab."""
        if isinstance(idx, torch.Tensor):
            idx = idx.cpu().numpy()
        slab = self.host_batch(idx)
        return self.make_batch_fn()({k: v.to(self.device) for k, v in slab.items()})


def prefetch_to_device(
    items: Iterable[Dict[str, torch.Tensor]], size: int = 2, device="cuda", stats: Optional[dict] = None
) -> Iterator[Dict[str, torch.Tensor]]:
    """Iterate ``items`` (dicts of host tensors) as dicts on ``device``,
    with a worker thread that draws them and copies up to ``size`` ahead of
    the consumer, on a side stream when ``device`` is CUDA. An exception on
    the worker re-raises here. ``stats``, when given, accumulates (added to
    what it holds):

    * ``items``: the dicts delivered;
    * ``wait_s``: the consumer's time blocked on the queue;
    * ``gather_s``: the worker's time drawing items (for ``epoch_slabs``,
      the slab gather on the host);
    * ``issue_s``: the worker's time issuing the copies;
    * ``copy_ms``: on CUDA, the copies' device time, from timing events
      around each item's copy on the side stream, read once the
      iteration ends.
    """
    dev = resolve_device(device)
    q: queue.Queue = queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    timed = stats is not None and side is not None
    copies = []  # (start, done) events of each item's copy, when timed

    def add(key: str, value: float) -> None:
        if stats is not None:
            stats[key] = stats.get(key, 0) + value

    def stage(item):
        if side is None:
            return {k: v.to(dev) for k, v in item.items()}, None
        with torch.cuda.stream(side):
            start = torch.cuda.Event(enable_timing=True) if timed else None
            if timed:
                start.record(side)
            moved = {k: v.to(dev, non_blocking=True) for k, v in item.items()}
            done = torch.cuda.Event(enable_timing=timed)
            done.record(side)
        if timed:
            copies.append((start, done))
        # the host item stays referenced until the consumer took the slab
        return moved, (done, item)

    def offer(x) -> bool:
        """Put ``x`` once there is room; False when the consumer left."""
        while not stop.is_set():
            try:
                q.put(x, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            it = iter(items)
            while True:
                t0 = time.perf_counter()
                item = next(it, end)
                if item is end:
                    break
                t1 = time.perf_counter()
                staged = stage(item)
                add("gather_s", t1 - t0)
                add("issue_s", time.perf_counter() - t1)
                if not offer(staged):
                    return
        except BaseException as e:  # re-raised by the consumer
            offer(e)
            return
        offer(end)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            t0 = time.perf_counter()
            got = q.get()
            add("wait_s", time.perf_counter() - t0)
            if got is end:
                return
            if isinstance(got, BaseException):
                raise got
            moved, pending = got
            if pending is not None:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(pending[0])
                for v in moved.values():
                    v.record_stream(consumer)
            add("items", 1)
            yield moved
    finally:
        stop.set()
        t.join()
        if copies:
            copies[-1][1].synchronize()
            add("copy_ms", sum(a.elapsed_time(b) for a, b in copies))
