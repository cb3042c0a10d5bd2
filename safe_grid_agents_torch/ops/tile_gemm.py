"""Mirror of ``csrc/tile_gemm.cuh``: how the grid-wide learner kernels (B4's
grid route, ``csrc/dqn_update_grid.cu``, and B6's wide route,
``csrc/ppo_wide_kernel.cu``) cut their products into tiles and split-K
parts, and which block of the co-resident grid runs each.

A product ``C[M, N] = Σ_k A(m, k)·B(k, n)`` is cut into ``BM × BN`` output
tiles; a product whose reduction is a sum over a batch is cut into parts of
``KC`` rows (``parts``), each tile of each part written to its own slice of
a partial buffer and joined in part order by a later phase. The items of a
phase (its jobs' tiles × parts, job after job) go to the grid's blocks in
turn: item ``i`` to block ``i % grid``. ``SMEM_BYTES`` is the shared memory
of the ring of ``STAGES`` staged k-chunks a block holds.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence, Tuple

THREADS = 256
BLOCKS_PER_SM = 2
BM = BN = 64
KT = 32
KC = 512
STAGES = 2


def slot_floats(rows: int) -> int:
    """Floats of one operand's staged chunk of ``rows`` rows, in either order
    (``[i][k]`` rows of ``KT + 4``, ``[k][i]`` rows of ``rows + 8``)."""
    return max(rows * (KT + 4), KT * (rows + 8))


SMEM_BYTES = 4 * STAGES * (slot_floats(BM) + slot_floats(BN))  # the copy ring


def parts(K: int) -> int:
    """Split-K parts of a reduction of length ``K``."""
    return -(-K // KC) if K > KC else 1


def scratch(*sizes: int) -> int:
    """Floats of a scratch holding buffers of ``sizes`` floats back to back,
    each from a 16-byte boundary (``r4`` in the header)."""
    at = 0
    for n in sizes[:-1]:
        at = (at + n + 3) & ~3
    return at + sizes[-1]


def grid(n_sm: int) -> int:
    """Blocks of the cooperative launch: ``BLOCKS_PER_SM`` on every SM (the
    launch raises where fewer are co-resident)."""
    return n_sm * BLOCKS_PER_SM


@dataclasses.dataclass(frozen=True)
class Job:
    """One product of a phase: ``M × N`` outputs, a reduction of ``K``, cut
    into ``splits`` parts (1: the whole K in each tile)."""
    M: int
    N: int
    K: int
    splits: int

    @classmethod
    def make(cls, M: int, N: int, K: int, split: bool) -> "Job":
        return cls(M, N, K, parts(K) if split else 1)

    @property
    def items(self) -> int:
        return -(-self.M // BM) * -(-self.N // BN) * self.splits

    def tiles(self) -> Iterator[Tuple[int, int, int, int, int, int, int]]:
        """``(part, m0, m1, n0, n1, k0, k1)`` of each item in the kernel's
        order (item = part · tiles + tile: the blocks at work at once share
        the k rows they read)."""
        tn = -(-self.N // BN)
        ntiles = self.items // self.splits
        for item in range(self.items):
            part, tile = item // ntiles, item % ntiles
            m0, n0 = (tile // tn) * BM, (tile % tn) * BN
            k0 = part * KC if self.splits > 1 else 0
            k1 = min(self.K, k0 + KC) if self.splits > 1 else self.K
            yield part, m0, min(self.M, m0 + BM), n0, min(self.N, n0 + BN), k0, k1

    def report(self) -> Tuple[int, int, int, int]:
        return self.M, self.N, self.K, self.splits


def blocks_of(jobs: Sequence[Job], n_grid: int) -> Iterator[Tuple[int, int, tuple]]:
    """``(block, job index, tile)`` of every item of a phase."""
    at = 0
    for q, job in enumerate(jobs):
        for tile in job.tiles():
            yield at % n_grid, q, tile
            at += 1
