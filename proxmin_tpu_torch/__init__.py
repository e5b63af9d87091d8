"""proxmin_tpu_torch: the PyTorch and CUDA port of proxmin_tpu.

The JAX package ``proxmin_tpu`` is the reference; this package mirrors its
module names (``operators``, ``utils``, ``linop``, ``solvers``, ``nmf``,
``ops``, ``special``, ``checkpoint``, ``functional``, ``export``,
``parallel``, ``calibrate``) so each
counterpart sits at the same relative path. It imports ``torch`` and
never ``jax``. Plain code is tensor ops on the device the inputs live on;
the hot NMF step is a hand-written CUDA kernel (``ops``, ``csrc/``) built
at first use.

Ported so far: the prox operators, the linear operators, the five
solvers (``pgm``, ``adaprox``, ``admm``, ``sdmm``, ``bsdmm``) with all of
their options, NMF by PGM and AdaProx on the ``"torch"`` and ``"cuda"``
engines and by bSDMM, checkpoint/resume of every solver's state through
a file, the pure solver factories of ``functional`` (batched under
``torch.func.vmap``, implicitly differentiable), and whole solves saved as
``torch.export`` programs by ``export``, and ``nmf(engine="auto")`` with
its H100 routing regions and runtime calibration (``calibrate``);
ROADMAP.md lists what follows.

Importing the package sets the float32 matmul policy
(:func:`precision.apply_f32_policy`): no TF32 anywhere.
"""

from .precision import apply_f32_policy

apply_f32_policy()

from .algorithms import *  # noqa: E402,F401,F403
from .operators import *  # noqa: E402,F401,F403
from . import algorithms  # noqa: E402,F401
from . import calibrate  # noqa: E402,F401
from . import checkpoint  # noqa: E402,F401
from . import export  # noqa: E402,F401
from . import functional  # noqa: E402,F401
from . import interop  # noqa: E402,F401
from . import linop  # noqa: E402,F401
from . import nmf  # noqa: E402,F401
from . import operators  # noqa: E402,F401
from . import special  # noqa: E402,F401
from . import utils  # noqa: E402,F401

__version__ = "0.1.0"
