"""Two-sample tests of outcomes over seeds, for telling whether the port's
outcome law on a recipe differs from the reference's (ROADMAP C.7, C.8):
Fisher's exact test on a 2 × 2 table of counts and the Mann–Whitney U test
on two samples of returns.

    python -m safe_grid_agents_torch.tools.seed_stats fisher K1 N1 K2 N2
        [--alternative two-sided|less|greater]
        # K1 of N1 seeds against K2 of N2; "less": the first share is lower

Plain Python: exact sums of the hypergeometric law for Fisher; for
Mann–Whitney the normal approximation with the tie correction and a
continuity correction (scipy's ``method="asymptotic"``), which
``tests/test_torch_repeat.py`` holds against scipy where it is installed.
"""
from __future__ import annotations

import argparse
import math
import sys
from typing import Sequence


def fisher_exact(k1: int, n1: int, k2: int, n2: int,
                 alternative: str = "two-sided") -> float:
    """p-value of Fisher's exact test on ``[[k1, n1 - k1], [k2, n2 - k2]]``.
    ``less``: the first sample's share is lower than the second's;
    ``greater``: higher; ``two-sided``: the tables no likelier than the
    observed one (with scipy's relative tolerance of 1e-7)."""
    total, k = n1 + n2, k1 + k2
    lo, hi = max(0, k - n2), min(k, n1)

    def pmf(x):
        return math.comb(n1, x) * math.comb(n2, k - x) / math.comb(total, k)

    if alternative == "less":
        return min(1.0, sum(pmf(x) for x in range(lo, k1 + 1)))
    if alternative == "greater":
        return min(1.0, sum(pmf(x) for x in range(k1, hi + 1)))
    if alternative != "two-sided":
        raise ValueError(alternative)
    p0 = pmf(k1)
    return min(1.0, sum(p for p in map(pmf, range(lo, hi + 1)) if p <= p0 * (1 + 1e-7)))


def mann_whitney(x: Sequence[float], y: Sequence[float]) -> tuple:
    """``(U of x, two-sided p)`` of the Mann–Whitney U test: mid-ranks for
    ties, the normal approximation with the tie correction and a
    continuity correction of 0.5."""
    n1, n2 = len(x), len(y)
    pooled = sorted((v, i) for i, v in enumerate(list(x) + list(y)))
    ranks = [0.0] * (n1 + n2)
    ties, at = [], 0
    while at < len(pooled):
        end = at
        while end + 1 < len(pooled) and pooled[end + 1][0] == pooled[at][0]:
            end += 1
        for j in range(at, end + 1):
            ranks[pooled[j][1]] = (at + end) / 2.0 + 1.0
        ties.append(end - at + 1)
        at = end + 1
    u1 = sum(ranks[:n1]) - n1 * (n1 + 1) / 2.0
    n = n1 + n2
    mu = n1 * n2 / 2.0
    var = n1 * n2 / 12.0 * ((n + 1) - sum(t ** 3 - t for t in ties) / (n * (n - 1)))
    if var <= 0.0:
        return u1, 1.0
    z = (abs(u1 - mu) - 0.5) / math.sqrt(var)
    return u1, min(1.0, math.erfc(max(z, 0.0) / math.sqrt(2.0)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="test", required=True)
    f = sub.add_parser("fisher")
    for name in ("k1", "n1", "k2", "n2"):
        f.add_argument(name, type=int)
    f.add_argument("--alternative", default="two-sided",
                   choices=("two-sided", "less", "greater"))
    args = p.parse_args(argv)
    pv = fisher_exact(args.k1, args.n1, args.k2, args.n2, args.alternative)
    print(f"Fisher's exact test, {args.k1}/{args.n1} against {args.k2}/{args.n2} "
          f"({args.alternative}): p = {pv:.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
