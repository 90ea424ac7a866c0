"""Powering unit schedule (paper §6), used by the ``paper`` series schedule.

x^2 .. x^n by the "maximize squaring" heuristic: cycle 0 squares x; cycle c
forms one odd power by a multiply, x^(2c+1) = x * x^(2c), and one even power
by a square, x^(2c+2) = (x^(c+1))^2 — two new Taylor terms per cycle.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

__all__ = ["schedule", "eval_powers"]

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
