"""Elementwise proximal operators on tensors.

Counterparts of :mod:`proxmin_tpu.operators` with the same signatures and
the same relative/absolute threshold convention. Every operator returns a
new tensor.
"""

import functools

import torch

from .special import lambertw_exp

__all__ = [
    "prox_id",
    "prox_zero",
    "prox_plus",
    "prox_unity",
    "prox_unity_plus",
    "prox_min",
    "prox_max",
    "prox_components",
    "prox_hard",
    "prox_hard_plus",
    "prox_soft",
    "prox_soft_plus",
    "prox_max_entropy",
    "AlternatingProjections",
    "get_thresh",
]


def _step_gamma(step, gamma):
    """Scale a continuous penalty parameter by the algorithm step size."""
    return gamma * step


def get_thresh(step, thresh, type):
    """``'relative'``: the threshold is in units of the function value and
    is multiplied by the step; ``'absolute'``: in units of ``X``, used as
    is."""
    if type not in ("relative", "absolute"):
        raise ValueError(f"type must be 'relative' or 'absolute', got {type!r}")
    if type == "relative":
        return _step_gamma(step, thresh)
    return thresh


def _like(X, v):
    """``v`` (Python or tensor scalar) as a tensor on ``X``'s device and
    dtype, so binary ops broadcast without a host round trip. A Python
    number becomes a fill on the device: copying it there from host memory
    would make the host wait for the stream (the ADMM solvers pass their
    steps as Python numbers)."""
    if type(v) in (bool, int, float):
        return torch.full((), v, dtype=X.dtype, device=X.device)
    return torch.as_tensor(v, dtype=X.dtype, device=X.device)


def _promoted(X, v):
    """``X`` and the threshold ``v`` as tensors of the dtype that JAX's
    promotion gives ``X`` and ``v`` together, on ``X``'s device: a Python
    number is weakly typed and keeps ``X``'s dtype; a tensor or a NumPy
    value promotes with it (a float64 threshold makes a float32 ``X``'s
    result float64, as in JAX; PyTorch itself would not promote ``X`` by a
    0-d tensor, so the dtype is set here)."""
    if type(v) in (bool, int, float):  # np.float64 subclasses float
        return X, _like(X, v)
    t = torch.as_tensor(v, device=X.device)
    dtype = torch.promote_types(X.dtype, t.dtype)
    return X.to(dtype), t.to(dtype)


def prox_id(X, step):
    """Identity proximal operator."""
    return X


def prox_zero(X, step):
    """Proximal operator projecting onto zero."""
    return torch.zeros_like(X)


def prox_plus(X, step):
    """Projection onto the non-negative orthant (NaN propagates)."""
    return torch.maximum(X, X.new_zeros(()))


def prox_unity(X, step, axis=0):
    """Projection onto sum=1 along an axis (rescaling)."""
    return X / torch.sum(X, dim=axis, keepdim=True)


def prox_unity_plus(X, step, axis=0):
    """Non-negative projection onto sum=1 along an axis."""
    return prox_unity(prox_plus(X, step), step, axis=axis)


def prox_min(X, step, thresh=0, type="relative"):
    """Projection onto numbers above ``thresh`` (floor)."""
    return torch.maximum(*_promoted(X, get_thresh(step, thresh, type)))


def prox_max(X, step, thresh=0, type="relative"):
    """Projection onto numbers below ``thresh`` (ceiling)."""
    return torch.minimum(*_promoted(X, get_thresh(step, thresh, type)))


def prox_components(X, step, prox=None, axis=0):
    """Split ``X`` along ``axis`` (0 or 1) and apply a prox to each slice.

    ``prox`` is a single callable or a list with one entry per slice;
    ``None`` entries are the identity."""
    K = X.shape[axis]
    if not isinstance(prox, (list, tuple)):
        prox = [prox] * K
    if len(prox) != K:
        raise ValueError(f"need {K} prox operators along axis {axis}, got "
                         f"{len(prox)}")
    prox = [p if p is not None else prox_id for p in prox]
    if axis == 0:
        Pk = [prox[k](X[k], step) for k in range(K)]
    elif axis == 1:
        Pk = [prox[k](X[:, k], step) for k in range(K)]
    else:
        raise NotImplementedError("prox_components supports axis 0 or 1")
    return torch.stack(Pk, dim=axis)


def prox_hard(X, step, thresh=0, type="relative"):
    """Hard thresholding: ``X`` if ``|X| >= thresh``, otherwise 0."""
    thresh_ = _like(X, get_thresh(step, thresh, type))
    return torch.where(torch.abs(X) < thresh_, torch.zeros_like(X), X)


def prox_hard_plus(X, step, thresh=0, type="relative"):
    """Hard thresholding then projection onto non-negative numbers."""
    return prox_plus(prox_hard(X, step, thresh=thresh, type=type), step)


def prox_soft(X, step, thresh=0, type="relative"):
    """Soft thresholding (L1 prox): ``sign(X) * max(|X| - thresh, 0)``."""
    X, thresh_ = _promoted(X, get_thresh(step, thresh, type))
    return torch.sign(X) * torch.maximum(torch.abs(X) - thresh_,
                                         X.new_zeros(()))


def prox_soft_plus(X, step, thresh=0, type="relative"):
    """Soft thresholding then projection onto non-negative numbers."""
    return prox_plus(prox_soft(X, step, thresh=thresh, type=type), step)


def prox_max_entropy(X, step, gamma=1, type="relative"):
    """Proximal operator of the maximum-entropy penalty
    ``gamma * sum_i x_i ln(x_i)``: ``gamma_ W(exp(X/gamma_ - 1) / gamma_)``
    where ``X > 0`` (``X`` elsewhere), with W the Lambert function, computed
    as :func:`~proxmin_tpu_torch.special.lambertw_exp` of
    ``X/gamma_ - 1 - log(gamma_)`` so ``exp`` never overflows."""
    gamma_ = _like(X, get_thresh(step, gamma, type))
    t = X / gamma_ - 1.0 - torch.log(gamma_)
    w = gamma_ * lambertw_exp(t)
    return torch.where(X > 0, w.to(X.dtype), X)


class AlternatingProjections:
    """Several proximal operators combined as alternating projections
    (POCS): the list is applied in reverse order (the first one last),
    ``repeat`` times. Returns a new tensor."""

    def __init__(self, prox_list=None, repeat=1):
        self.operators = []
        self.repeat = repeat
        if prox_list is not None:
            self.operators += list(prox_list)

    def __call__(self, X, step):
        for _ in range(self.repeat):
            for prox in self.operators[::-1]:
                X = prox(X, step)
        return X

    def find(self, cls):
        """Index of the first operator that is ``cls`` or a
        ``functools.partial`` of it; -1 when there is none."""
        for i, prox in enumerate(self.operators):
            if isinstance(prox, functools.partial):
                if prox.func is cls:
                    return i
            elif prox is cls:
                return i
        return -1


# Separable-prox markers (as in proxmin_tpu.operators). The scaled proximal
# problem ``min_z g(z) + (1/(2 alpha)) (z - x)^T diag(Psi) (z - x)``
# decomposes per element into ``prox_{g_i}`` with step ``alpha / Psi_i``,
# its exact closed form, which ``adaprox(separable_prox=...)`` uses instead
# of the prox sub-iterations. Whether that is valid depends on what the
# operator's ``step`` means, so each operator carries a
# ``separable_when(kwargs) -> bool`` predicate over its bound keywords:
#
# * fixed constraint sets (the step is ignored): always for prox_id,
#   prox_zero, prox_plus; prox_min/prox_max only with ``type="absolute"``
#   or ``thresh=0`` (a relative threshold scales the SET by the step);
# * step-scaled penalties: prox_soft, prox_soft_plus and prox_max_entropy
#   with ``type="relative"``;
# * prox_hard/prox_hard_plus never: L0's nonconvex fixed points need the
#   sub-iterations.

def _sep_always(kw):
    return True


def _sep_fixed_interval(kw):
    if kw.get("type", "relative") == "absolute":
        return True
    t = kw.get("thresh", 0)
    try:
        return float(t) == 0.0
    except (TypeError, ValueError, RuntimeError):
        return False  # array thresholds: be conservative


def _sep_scaled_penalty(kw):
    return kw.get("type", "relative") == "relative"


for _p in (prox_id, prox_zero, prox_plus):
    _p.separable_when = _sep_always
for _p in (prox_min, prox_max):
    _p.separable_when = _sep_fixed_interval
for _p in (prox_soft, prox_soft_plus, prox_max_entropy):
    _p.separable_when = _sep_scaled_penalty
del _p
