"""Powering unit schedule (paper §6), used by the ``paper`` series schedule
and by the ILM mode, and the squaring unit's hardware model (paper §5).

x^2 .. x^n by the "maximize squaring" heuristic: cycle 0 squares x; cycle c
forms one odd power by a multiply, x^(2c+1) = x * x^(2c), and one even power
by a square, x^(2c+2) = (x^(c+1))^2 — two new Taylor terms per cycle.

``hw_cost`` is the reference's component-count model of the §5 claim (the
squaring unit needs under half the ILM multiplier's hardware): the
multiplier duplicates the priority encoder, LOD, shifter and adder and
needs a decoder for 2^(k1+k2); the squarer needs one of each and writes 4^k
as (100)_2 << k with no decoder.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

__all__ = ["schedule", "eval_powers", "op_counts", "HwCost", "hw_cost"]

Op = Tuple[str, Any, int]  # (kind, operand(s), result power)


def schedule(n: int) -> List[Op]:
    """§6 op schedule producing x^2..x^n: ('square', src, dst) | ('mul', (1, src), dst)."""
    if n < 2:
        return []
    ops: List[Op] = [("square", 1, 2)]
    c = 1
    while True:
        odd, even = 2 * c + 1, 2 * c + 2
        if odd > n and even > n:
            break
        if odd <= n:
            ops.append(("mul", (1, odd - 1), odd))
        if even <= n:
            ops.append(("square", even // 2, even))
        c += 1
    return ops


def eval_powers(x, n: int, *, mul: Callable, square: Callable) -> Dict[int, Any]:
    """Execute the §6 schedule with the given multiplier and squarer."""
    powers: Dict[int, Any] = {1: x}
    for kind, src, dst in schedule(n):
        if kind == "square":
            powers[dst] = square(powers[src])
        else:
            a, b = src
            powers[dst] = mul(powers[a], powers[b])
    return powers


def op_counts(n: int, sched: str = "paper") -> Dict[str, int]:
    """Multiplies, squares, adds, cycles and series terms needed to evaluate
    sum_{k<=n} m^k in the §6 (``paper``) or the ``factored`` schedule."""
    if sched == "paper":
        ops = schedule(n)
        sq = sum(1 for o in ops if o[0] == "square")
        mu = sum(1 for o in ops if o[0] == "mul")
        # one odd + even pair per cycle after the initial square (§6)
        cycles = 1 + max(0, (n - 2 + 1) // 2) if n >= 2 else 0
        return {"mul": mu, "square": sq, "add": max(0, n), "cycles": cycles,
                "terms": n + 1}
    if sched == "factored":
        if n <= 0:
            return {"mul": 0, "square": 0, "add": 0, "cycles": 0, "terms": 1}
        j = max(1, math.ceil(math.log2(n + 1)))
        # t starts at m^2 (one square); each further factor costs a square
        # and a multiply.
        return {"mul": j - 1, "square": j - 1, "add": j, "cycles": j,
                "terms": 2**j}
    raise ValueError(sched)


@dataclass(frozen=True)
class HwCost:
    """Component counts, weighted in relative area units."""

    priority_encoder: int
    lod: int
    barrel_shifter: int
    adder: int
    decoder: int
    weights: Dict[str, float] = field(default_factory=lambda: {
        "priority_encoder": 3.0, "lod": 3.0, "barrel_shifter": 2.0,
        "adder": 1.5, "decoder": 1.0,
    })

    def units(self) -> int:
        return (self.priority_encoder + self.lod + self.barrel_shifter
                + self.adder + self.decoder)

    def area(self) -> float:
        return sum(getattr(self, k) * w for k, w in self.weights.items())


def hw_cost() -> Dict[str, Any]:
    """Paper §5: squaring unit vs iterative-log multiplier component counts."""
    multiplier = HwCost(priority_encoder=2, lod=2, barrel_shifter=2, adder=2, decoder=1)
    squarer = HwCost(priority_encoder=1, lod=1, barrel_shifter=1, adder=1, decoder=0)
    return {"multiplier": multiplier, "squarer": squarer,
            "area_ratio": squarer.area() / multiplier.area(),
            "unit_ratio": squarer.units() / multiplier.units()}
