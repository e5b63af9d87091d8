"""Carrying a solve across from the JAX package.

The factors ``A``, ``S`` and the data ``Y`` cross as NumPy arrays (the port
takes them as they are). A solver's ``.state`` crosses with
:func:`state_from_numpy`, after its JAX leaves have been turned into NumPy
arrays (``np.asarray``), so a JAX solve can be continued in the port.
"""

import numpy as np
import torch

from .solvers.common import as_tensor

__all__ = ["state_from_numpy"]


def _py(v):
    """A 0-d NumPy array (or NumPy scalar) as the Python value it holds."""
    if isinstance(v, (np.ndarray, np.generic)) and np.ndim(v) == 0:
        return v.item()
    return v


def _tensor(v, device, dtype=None):
    """A NumPy leaf as a tensor of its own dtype (or ``dtype``), copied."""
    return as_tensor(np.array(v), dtype, device)


def _empty_stepper(state, what):
    if len(tuple(state.get("stepper_state", ()))) != 0:
        raise NotImplementedError(
            f"{what} states with a stateful stepper (Barzilai-Borwein, "
            "strided) have no counterpart in the port yet (ROADMAP.md "
            "Queue 1 items 6 and 12)")


def _fused_pgm_state(state, device):
    stride = tuple(_py(v) for v in state.get("stride_config", (0, False)))
    if (bool(_py(state["weighted"])) or int(stride[0]) > 1
            or bool(stride[1]) or _py(state.get("store_dtype")) is not None):
        raise NotImplementedError(
            "only the unweighted, unstrided float32 nmf_pgm_fused state "
            "has a counterpart in the port so far (ROADMAP.md Queue 1 "
            "item 6)")
    return {
        "kind": "nmf_pgm_fused", "weighted": False,
        "stride_config": (0, False), "store_dtype": None,
        "tile_n": int(_py(state["tile_n"])), "it": int(_py(state["it"])),
        "converged": np.asarray(state["converged"], bool),
        "diverged": bool(_py(state["diverged"])),
        "loss": float(_py(state["loss"])),
        "steps": _tensor(state["steps"], device, torch.float32),
    }


def _pgm_state(state, device):
    _empty_stepper(state, "pgm")
    return {
        "x_prev": tuple(_tensor(x, device) for x in state.get("x_prev", ())),
        "t": _tensor(state["t"], device),
        "T": _tensor(state["T"], device),
        "f_prev": _tensor(state["f_prev"], device),
        "stepper_state": (),
        "it": int(_py(state["it"])),
        "converged": _tensor(state["converged"], device, torch.bool),
        "diverged": _tensor(state["diverged"], device, torch.bool),
    }


def _adaprox_state(state, device):
    """Both JAX adaprox layouts: the driver's (``proxmin_tpu.adaprox``,
    ``nmf(engine="xla")``) and the fused runner's (``engine="pallas"``),
    which adds the kernel's row sums, the loss and its configuration."""
    _empty_stepper(state, "adaprox")
    out = {
        "M": tuple(_tensor(m, device) for m in state["M"]),
        "V": tuple(_tensor(v, device) for v in state["V"]),
        "Vhat": tuple(_tensor(v, device) for v in state["Vhat"]),
        "stepper_state": (),
        "it": int(_py(state["it"])),
        "converged": _tensor(state["converged"], device, torch.bool),
        "diverged": _tensor(state["diverged"], device, torch.bool),
    }
    if "fused_config" in state:
        cfg = {k: _py(v) for k, v in dict(state["fused_config"]).items()}
        if cfg.get("store_dtype") is not None:
            raise NotImplementedError(
                "a fused adaprox state with a reduced store_dtype has no "
                "counterpart in the port yet (ROADMAP.md Queue 2)")
        out.update(
            converged=np.asarray(state["converged"], bool),
            diverged=bool(_py(state["diverged"])),
            rowsum=_tensor(state["rowsum"], device, torch.float32),
            loss=float(_py(state["loss"])),
            fused_config={"tile_n": int(cfg["tile_n"]), "store_dtype": None,
                          "moment_dtype": cfg.get("moment_dtype")})
    return out


def state_from_numpy(state, device=None):
    """Turn a ``proxmin_tpu`` solver ``.state`` (leaves as NumPy arrays or
    Python scalars) into the port's ``.state`` on ``device`` (default: the
    CPU).

    Supported: the ``pgm`` state (``nmf(engine="xla")``, continued with
    ``engine="torch"``) with a stateless stepper; the unweighted exact
    ``nmf_pgm_fused`` state (``engine="pallas"``, continued with
    ``engine="cuda"``); and both ``adaprox`` states, the driver's and the
    fused runner's (continued with ``nmf(algorithm="adaprox")`` on either
    engine, or ``adaprox(state=...)``), bfloat16 moments included. Other
    states raise ``NotImplementedError``.
    """
    kind = _py(state.get("kind"))
    if kind == "nmf_pgm_fused":
        return _fused_pgm_state(state, device)
    if kind is not None:
        raise NotImplementedError(
            f"no counterpart in the port for a {kind!r} state yet")
    if "M" in state:
        return _adaprox_state(state, device)
    return _pgm_state(state, device)
