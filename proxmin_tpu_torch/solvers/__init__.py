"""Solver drivers of the port (``pgm`` and ``adaprox`` so far)."""

from .adaprox import adaprox  # noqa: F401
from .pgm import pgm  # noqa: F401
