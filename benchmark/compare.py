"""The comparison that decides ``correct``: the measured program's
readings of its first three steps against the reference's.

Each gap is the distance between the program's and the reference's
reading divided by the larger of the reference's reading and the group's
median reference reading (a reading that is all but zero in the
reference is held to the group's scale, not to its own). The numbers:

- ``loss``: the sum of the gaps of step 1's loss terms;
- ``prior1``: the gap of step 1's prior (KL) term alone, which sums the
  encoder's mu and variance over the batch: the forward's most exact
  reading, apart from the terms' sum, where the reconstruction terms'
  rounding hides it;
- ``grad1``: the median leaf's gap of the first gradient's norm as the
  optimizer took it;
- ``change3``: the median leaf's gap of the norm of its change over the
  three steps;
- ``change3_group``: the worst gap of one dtype group's change over the
  three steps, the norm taken over all the group's leaves together (a
  group: the leaves that the configuration stores with one weight and
  moment dtype, which the optimizer updates in one kernel launch). The
  median leaf cannot see a launch that leaves its group unmoved where the
  other group holds more leaves; the group's norm reads 1 then;
- ``state3``: the worst gap over BatchNorm's running statistics, the
  streaming scrubbers' states, MCMI's samples and each discriminator's
  change, after step 3.

``grad1``, ``change3`` and ``change3_group`` leave out the leaves whose first gradient in the
reference is under a thousandth of the median leaf's (a bias under
BatchNorm: its gradient is nought to rounding, and under Adam it moves by
round-off alone). They take the median leaf, and ``loss`` step 1 alone and
its terms together, because the worst leaf, the worst term and the later
steps swing with what the configuration itself states: the rotation loss's gradient is ruled by a
few rotations next to its asin's singularity, which bf16 moves across the
clamp, and a bf16 leaf's change over three steps of about a fifth of its
unit in the last place is mostly its stochastic rounding (PERF.md, 4).

A reading that is not finite, or one that a side lacks, makes its number
infinite. A limit of None leaves its number uncompared (the cell's
limits file says why).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Tuple

NUMBERS = ("loss", "prior1", "grad1", "change3", "change3_group", "state3")
QUIET_GRAD = 1e-3


def gaps(prog: Dict[str, float], ref: Dict[str, float]) -> Dict[str, float]:
    """Each reading's gap (module docstring); infinite where a side lacks
    the reading or either is not finite."""
    if not ref:
        return {}
    med = statistics.median(abs(v) for v in ref.values())
    out = {}
    for k in sorted(set(prog) | set(ref)):
        p, r = prog.get(k, math.nan), ref.get(k, math.nan)
        if not (math.isfinite(p) and math.isfinite(r)):
            out[k] = math.inf
            continue
        scale = max(abs(r), med)
        out[k] = abs(p - r) / scale if scale > 0 else (0.0 if p == r else math.inf)
    return out


def gap(p: float, r: float) -> float:
    """|p - r| / |r|; infinite where either is not finite."""
    if not (math.isfinite(p) and math.isfinite(r)):
        return math.inf
    return abs(p - r) / abs(r) if r else (0.0 if p == r else math.inf)


def worst(g: Dict[str, float]) -> Tuple[float, str]:
    if not g:
        return 0.0, ""
    k = max(g, key=g.get)
    return g[k], k


def total(g: Dict[str, float]) -> Tuple[float, str]:
    return sum(g.values()), "sum of %d terms" % len(g)


def median(g: Dict[str, float]) -> Tuple[float, str]:
    if not g:
        return 0.0, ""
    if any(math.isinf(v) for v in g.values()):
        return worst(g)
    v = statistics.median(g.values())
    return v, "median of %d leaves" % len(g)


def group_gaps(prog: Dict[str, float], ref: Dict[str, float], groups: Dict[str, str]) -> Dict[str, float]:
    """Each group's gap of the norm over its leaves of ``prog`` against
    ``ref`` (per-leaf norms, so a group's norm is the root of their squares'
    sum); infinite where a leaf's reading is missing or not finite."""
    out = {}
    for g in sorted(set(groups[n] for n in ref)):
        names = [n for n in ref if groups[n] == g]
        p = math.sqrt(sum(prog.get(n, math.nan) ** 2 for n in names))
        r = math.sqrt(sum(ref[n] ** 2 for n in names))
        out[g] = abs(p - r) / r if math.isfinite(p) and r > 0 else (0.0 if p == r else math.inf)
    return out


def numbers(prog: dict, ref: dict, groups: Dict[str, str]) -> Dict[str, Tuple[float, str]]:
    """Each number of the module docstring with the reading that sets it;
    ``groups`` names each leaf's dtype group."""
    grads = ref["grad1"]
    med = statistics.median(grads.values()) if grads else 0.0
    moving = [n for n, g in grads.items() if g >= QUIET_GRAD * med]

    def leaves(reading):
        return {n: prog[reading].get(n, math.nan) for n in moving}, {n: ref[reading][n] for n in moving}

    value, where = worst(group_gaps(*leaves("change3"), groups))
    return {
        "loss": total(gaps(prog["loss"]["step1"], ref["loss"]["step1"])),
        "prior1": (gap(prog["loss"]["step1"].get("prior", math.nan), ref["loss"]["step1"]["prior"]), "step 1's prior"),
        "grad1": median(gaps(*leaves("grad1"))),
        "change3": median(gaps(*leaves("change3"))),
        "change3_group": (value, "group " + where),
        "state3": worst(gaps(prog["state3"], ref["state3"])),
    }


def judge(nums: Dict[str, Tuple[float, str]], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict], list]:
    """(correct, each number with its limit, one line a number)."""
    table, lines, ok = {}, [], True
    for name in NUMBERS:
        value, where = nums[name]
        limit = limits[name]
        table[name] = {"value": value, "limit": limit}
        if limit is None:
            lines.append(f"{name} {value!r} not compared ({where})")
            continue
        ok = ok and value <= limit
        lines.append(f"{name} {value!r} limit {limit!r}{' ok' if value <= limit else ' FAILED'} ({where})")
    return ok, table, lines
