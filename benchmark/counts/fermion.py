"""The work of K11, the program's whole CG solve in one launch, counted from
the shapes, whatever implements it. Plain Python: it imports nothing of
the program.

One iteration of the CG on the normal operator, per site of the lattice
and per chain (operations as ``csrc/fermion.cu`` counts them): even-odd,
four hop passes of 44 and two combines of 12 on half the sites, and the
update's 40 on the even half, 120; without even-odd, two hop passes of 44
and two combines of 12 on every site and the update's 40, 152. The bytes
of a solve, read once and written once: the links (two complex fp32 a
site, 16 B), and b, the start x0 and the solution x (a complex fp32
spinor, 16 B, each on the even sites alone where even-odd).
"""
from __future__ import annotations

from benchmark.counts.work import bound

ITER_OPS = {True: 120, False: 152}     # a site a chain, by even-odd
LINK_BYTES = 16
SPINOR_BYTES = 16


def iteration_ops(B: int, L: int, eo: bool = True) -> float:
    """Operations of one CG iteration over B chains of L^2 sites."""
    return float(ITER_OPS[eo] * B * L * L)


def solve_bytes(B: int, L: int, eo: bool = True) -> float:
    """Bytes a solve of B chains of L^2 sites reads and writes once."""
    spinors = 3 * SPINOR_BYTES * (0.5 if eo else 1.0)
    return float((LINK_BYTES + spinors) * B * L * L)


def k11_bound(B: int, L: int, solves: int, iters: int,
              eo: bool = True) -> dict:
    """The least time (ms) of ``solves`` K11 solves over B chains of L^2
    sites that ran ``iters`` iterations in all."""
    return bound(solves * solve_bytes(B, L, eo),
                 iters * iteration_ops(B, L, eo))
