"""Solver API: the reference's flat namespace. The five iterative solvers
(``pgm``, ``adaprox``, ``admm``, ``sdmm``, ``bsdmm``) live in
``proxmin_tpu_torch.solvers`` as host loops over tensor ops."""

from .solvers.adaprox import adaprox  # noqa: F401
from .solvers.admm import admm, sdmm  # noqa: F401
from .solvers.bsdmm import bsdmm  # noqa: F401
from .solvers.pgm import pgm  # noqa: F401

__all__ = ["pgm", "adaprox", "admm", "sdmm", "bsdmm"]
