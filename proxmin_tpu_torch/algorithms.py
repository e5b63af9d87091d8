"""Solver API: the reference's flat namespace. Only ``pgm`` is ported so
far; ``adaprox``, ``admm``, ``sdmm`` and ``bsdmm`` follow in later
slices (ROADMAP.md Queue 1)."""

from .solvers.pgm import pgm  # noqa: F401

__all__ = ["pgm"]
