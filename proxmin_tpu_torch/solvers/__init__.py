"""The port's solvers, each a host loop over tensor ops."""

from .adaprox import adaprox  # noqa: F401
from .admm import admm, sdmm  # noqa: F401
from .bsdmm import bsdmm  # noqa: F401
from .pgm import pgm  # noqa: F401
