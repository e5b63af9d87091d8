"""Carrying a solve across from the JAX package.

The factors ``A``, ``S`` and the data ``Y`` cross as NumPy arrays (the port
takes them as they are). A solver's ``.state`` crosses with
:func:`state_from_numpy`, after its JAX leaves have been turned into NumPy
arrays (``np.asarray``), so a JAX solve can be continued in the port.
"""

import numpy as np
import torch

__all__ = ["state_from_numpy"]


def _py(v):
    """A 0-d NumPy array (or NumPy scalar) as the Python value it holds."""
    if isinstance(v, (np.ndarray, np.generic)) and np.ndim(v) == 0:
        return v.item()
    return v


def _tensor(v, device):
    return torch.as_tensor(np.array(v), device=device)


def state_from_numpy(state, device=None):
    """Turn a ``proxmin_tpu`` solver ``.state`` (leaves as NumPy arrays or
    Python scalars) into the port's ``.state`` on ``device`` (default: the
    CPU).

    Supported: the ``pgm`` state (``nmf(engine="xla")``, continued with
    ``engine="torch"``) with a stateless stepper, and the unweighted exact
    ``nmf_pgm_fused`` state (``engine="pallas"``, continued with
    ``engine="cuda"``). Other states raise ``NotImplementedError``.
    """
    kind = _py(state.get("kind"))
    if kind == "nmf_pgm_fused":
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
            "steps": _tensor(state["steps"], device).to(torch.float32),
        }
    if kind is not None:
        raise NotImplementedError(
            f"no counterpart in the port for a {kind!r} state yet")
    if len(tuple(state.get("stepper_state", ()))) != 0:
        raise NotImplementedError(
            "pgm states with a stateful stepper (Barzilai-Borwein, strided) "
            "have no counterpart in the port yet (ROADMAP.md Queue 1 item 12)")
    return {
        "x_prev": tuple(_tensor(x, device) for x in state.get("x_prev", ())),
        "t": _tensor(state["t"], device),
        "T": _tensor(state["T"], device),
        "f_prev": _tensor(state["f_prev"], device),
        "stepper_state": (),
        "it": int(_py(state["it"])),
        "converged": _tensor(state["converged"], device).to(torch.bool),
        "diverged": _tensor(state["diverged"], device).to(torch.bool),
    }
