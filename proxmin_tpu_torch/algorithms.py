"""Solver API: the reference's flat namespace. ``pgm`` and ``adaprox`` are
ported; ``admm``, ``sdmm`` and ``bsdmm`` follow in later slices
(ROADMAP.md Queue 1)."""

from .solvers.adaprox import adaprox  # noqa: F401
from .solvers.pgm import pgm  # noqa: F401

__all__ = ["pgm", "adaprox"]
