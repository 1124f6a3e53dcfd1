"""Reduction of a profiled slice of steps to device busy time, idle share,
kernel counts and the breakdown.

Events are plain records ``{"name", "device", "start", "end"}`` in
microseconds (``device`` true for what ran on the card: kernels, copies,
fills). ``from_profiler`` makes them from a ``torch.profiler`` session,
whose kernel events carry their own device-side start and end, graph
replays included. Copies (``Memcpy``) and fills (``Memset``) are counted
apart from kernels.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

TOP = 10
NOT_KERNELS = ("Memcpy", "Memset")


def from_profiler(prof) -> List[dict]:
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and getattr(e, "is_user_annotation", False):
            continue  # a host range mirrored on the device's timeline, no work of its own
        tr = e.time_range
        out.append({"name": e.name, "device": e.device_type == DeviceType.CUDA, "start": float(tr.start),
                    "end": float(tr.end)})
    return out


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``intervals`` as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in merge(intervals))


def is_kernel(ev: dict) -> bool:
    return ev["device"] and not ev["name"].startswith(NOT_KERNELS)


def summarize(events: List[dict], steps: int, window: Tuple[float, float], window_s: float) -> Optional[dict]:
    """What the per-layer readers take from a slice of ``steps`` steps whose
    host span is ``window`` (profiler microseconds) and ``window_s``
    seconds on the host clock: busy seconds (the union of device
    intervals), kernels and copies a step, the idle share of the window,
    and the breakdown. None when the slice holds no device event."""
    lo, hi = window
    dev = [e for e in events if e["device"] and e["end"] > lo and e["start"] < hi]
    if not dev:
        return None
    clipped = [(max(e["start"], lo), min(e["end"], hi)) for e in dev]
    busy_s = union_length(clipped) * 1e-6
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (e["end"] - e["start"]) * 1e-6
    return {
        "steps": steps,
        "busy_s": busy_s,
        "window_s": window_s,
        "idle_share": max(0.0, 1.0 - busy_s / window_s),
        "kernels_per_step": sum(1 for e in dev if is_kernel(e)) / steps,
        "copies_per_step": sum(1 for e in dev if not is_kernel(e)) / steps,
        "device_ops": sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": idle_gaps(events, merge(clipped), window),
    }


def idle_gaps(events: List[dict], busy: List[Tuple[float, float]], window: Tuple[float, float]) -> list:
    """The seconds the device stood idle in ``window``, by the innermost host
    event open at the middle of each gap, most first."""
    lo, hi = window
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    host = sorted((e for e in events if not e["device"]), key=lambda h: h["start"])
    totals: Dict[str, float] = {}
    active: List[dict] = []
    j = 0
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        while j < len(host) and host[j]["start"] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h["end"] >= mid]
        name = min(active, key=lambda h: h["end"] - h["start"])["name"] if active else "no host event"
        totals[name] = totals.get(name, 0.0) + (e - s) * 1e-6
    return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[:TOP]
