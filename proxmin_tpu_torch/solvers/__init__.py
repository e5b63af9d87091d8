"""Solver drivers of the port (``pgm`` so far)."""

from .pgm import pgm  # noqa: F401
