"""Carrying a solve across from the JAX package.

The factors ``A``, ``S`` and the data ``Y`` cross as NumPy arrays (the port
takes them as they are). A solver's ``.state`` crosses with
:func:`state_from_numpy`, after its JAX leaves have been turned into NumPy
arrays (``np.asarray``), so a JAX solve can be continued in the port.
"""

import numpy as np
import torch

from .solvers.common import as_tensor, default_device, map_leaves

__all__ = ["state_from_numpy"]


def _py(v):
    """A 0-d NumPy array (or NumPy scalar) as the Python value it holds."""
    if isinstance(v, (np.ndarray, np.generic)) and np.ndim(v) == 0:
        return v.item()
    return v


def _tensor(v, device, dtype=None):
    """A NumPy leaf as a tensor of its own dtype (or ``dtype``), copied."""
    return as_tensor(np.array(v), dtype, device)


def _stepper_state(v, device):
    """A JAX stepper state as the port's: tuples stay tuples, integer
    scalars (the strided steppers' stride and next-refresh clock) become
    host integers, other leaves tensors of their dtype on ``device``."""
    if isinstance(v, (tuple, list)):
        return tuple(_stepper_state(x, device) for x in v)
    a = np.asarray(v)
    if a.ndim == 0 and a.dtype.kind in "iu":
        return int(a)
    return _tensor(a, device)


def _fused_pgm_state(state, device):
    """The three ``nmf_pgm_fused`` layouts: ``"steps"`` is K1's Gram
    (exact), ``(sA, sS, Gram, stride, next)`` (unweighted strided) or
    ``(sA, sS, v, stride, next)`` (weighted)."""
    stride = tuple(_py(v) for v in state.get("stride_config", (0, False)))
    sdt = _py(state.get("store_dtype"))
    steps = state["steps"]
    if isinstance(steps, (tuple, list)):
        sA, sS, aux, stride_c, nxt = steps
        steps = (*(_tensor(v, device, torch.float32) for v in (sA, sS, aux)),
                 int(np.asarray(stride_c)), int(np.asarray(nxt)))
    else:
        steps = _tensor(steps, device, torch.float32)
    return {
        "kind": "nmf_pgm_fused", "weighted": bool(_py(state["weighted"])),
        "stride_config": (int(stride[0]), bool(stride[1])),
        "store_dtype": None if sdt is None else str(sdt),
        "tile_n": int(_py(state["tile_n"])), "it": int(_py(state["it"])),
        "converged": np.asarray(state["converged"], bool),
        "diverged": bool(_py(state["diverged"])),
        "loss": float(_py(state["loss"])),
        "steps": steps,
    }


def _pgm_state(state, device):
    return {
        "x_prev": tuple(_tensor(x, device) for x in state.get("x_prev", ())),
        "t": _tensor(state["t"], device),
        "T": _tensor(state["T"], device),
        "f_prev": _tensor(state["f_prev"], device),
        "stepper_state": _stepper_state(state.get("stepper_state", ()),
                                        device),
        "it": int(_py(state["it"])),
        "converged": _tensor(state["converged"], device, torch.bool),
        "diverged": _tensor(state["diverged"], device, torch.bool),
    }


def _adaprox_state(state, device):
    """Both JAX adaprox layouts: the driver's (``proxmin_tpu.adaprox``,
    ``nmf(engine="xla")``) and the fused runner's (``engine="pallas"``),
    which adds the kernel's row sums, the loss and its configuration."""
    out = {
        "M": tuple(_tensor(m, device) for m in state["M"]),
        "V": tuple(_tensor(v, device) for v in state["V"]),
        "Vhat": tuple(_tensor(v, device) for v in state["Vhat"]),
        "stepper_state": _stepper_state(state.get("stepper_state", ()),
                                        device),
        "it": int(_py(state["it"])),
        "converged": _tensor(state["converged"], device, torch.bool),
        "diverged": _tensor(state["diverged"], device, torch.bool),
    }
    if "fused_config" in state:
        cfg = {k: _py(v) for k, v in dict(state["fused_config"]).items()}
        sdt = cfg.get("store_dtype")
        out.update(
            converged=np.asarray(state["converged"], bool),
            diverged=bool(_py(state["diverged"])),
            rowsum=_tensor(state["rowsum"], device, torch.float32),
            loss=float(_py(state["loss"])),
            fused_config={"tile_n": int(cfg["tile_n"]),
                          "store_dtype": None if sdt is None else str(sdt),
                          "moment_dtype": cfg.get("moment_dtype")})
    return out


def _tensors(v, device):
    """A tensor, or nested tuples of them (the Z/U of several
    constraints or blocks), from NumPy leaves."""
    return map_leaves(lambda a: _tensor(a, device), v)


def _admm_state(state, device):
    """An ``admm``/``sdmm`` state (the keys of the JAX
    ``_resume_state``): Z, U and the stall detector's residual as tensors
    (tuples of them for several constraints), the slack, the clocks and the
    flags as host values, the residual-balancing multiplier as a 0-d
    tensor."""
    return {
        "z": _tensors(state["z"], device),
        "u": _tensors(state["u"], device),
        "r_prev": _tensors(state["r_prev"], device),
        "slack": float(_py(state["slack"])),
        "step_scale": _tensor(state["step_scale"], device),
        "it": int(_py(state["it"])),
        "total_it": int(_py(state["total_it"])),
        "converged": bool(_py(state["converged"])),
        "diverged": bool(_py(state["diverged"])),
    }


def _host_ints(v):
    """A stateful bsdmm stepper's state: integer arrays (the per-block
    strides and next-refresh sweeps) as tuples of host integers."""
    a = np.asarray(v)
    return int(a) if a.ndim == 0 else tuple(int(i) for i in a)


def _bsdmm_state(state, device):
    """A ``bsdmm`` state: per-block Z/U as nested tuples of tensors, the
    carried steps as tuples of 0-d tensors, the sweep clock and the flags
    as host values; in a stepper state (``WeightedBSDMMStepper``'s ``(v,
    strides, next_refresh)``) the integer leaves become host integers."""
    def stepper_leaf(v):
        a = np.asarray(v)
        return _host_ints(a) if a.dtype.kind in "iu" else _tensor(a, device)

    cfg = tuple(_py(c) for c in state["stride_config"])
    return {
        "z": _tensors(state["z"], device),
        "u": _tensors(state["u"], device),
        "steps_f": tuple(_tensor(s, device)
                         for s in np.asarray(state["steps_f"])),
        "steps_g": _tensors(state["steps_g"], device),
        "steps_state": map_leaves(stepper_leaf, state["steps_state"]),
        "it": int(_py(state["it"])),
        "stride_config": (int(cfg[0]), int(cfg[1]), bool(cfg[2])),
        "converged": tuple(bool(c) for c in np.asarray(state["converged"])),
        "diverged": bool(_py(state["diverged"])),
    }


def _sharded_state(state, kind, device, mesh, data_axis, model_axis):
    """A JAX ``nmf_pgm_sharded`` or ``nmf_adaprox_sharded`` state on
    ``mesh``: the clock, the flags and the loss as host values, the frozen
    strided steps as 0-d tensors, and each sharded carry (the power
    iterate ``v`` as (N, K) over ``data_axis``; the moments laid out as
    their blocks) as a ``DTensor`` of which every rank holds its slice."""
    from .parallel.sharding import _put

    if mesh is None:
        raise ValueError(f"a {kind!r} state is sharded: pass the mesh= "
                         "(and its data_axis/model_axis) that the solve "
                         "continues on")
    out = {"kind": kind, "weighted": bool(_py(state["weighted"])),
           "it": int(_py(state["it"])),
           "conv_A": bool(_py(state.get("conv_A", False))),
           "conv_S": bool(_py(state.get("conv_S", False))),
           "loss": float(_py(state.get("loss", 0.0)))}
    if kind == "nmf_adaprox_sharded":
        for k, spec in (("MA", (model_axis, None)), ("VA", (model_axis, None)),
                        ("MS", (None, data_axis)), ("VS", (None, data_axis))):
            out[k] = _put(np.asarray(state[k]), mesh, spec)
        return out
    cfg = tuple(_py(c) for c in state.get("stride_config", (0, False)))
    out.update(strided=bool(_py(state["strided"])),
               stride_config=(int(cfg[0]), bool(cfg[1])))
    if out["strided"]:
        out.update(step_A=_tensor(state["step_A"], device),
                   step_S=_tensor(state["step_S"], device),
                   stride=int(_py(state["stride"])),
                   seg_end=int(_py(state["seg_end"])))
        if out["weighted"]:
            out["v"] = _put(np.asarray(state["v"]), mesh, (data_axis, None))
    return out


def state_from_numpy(state, device=None, mesh=None, data_axis="data",
                     model_axis=None):
    """Turn a ``proxmin_tpu`` solver ``.state`` (leaves as NumPy arrays or
    Python scalars) into the port's ``.state`` on ``device`` (default: the
    CUDA device; without one, pass ``device="cpu"``).

    Supported: the ``pgm`` state (``nmf(engine="xla")``, continued with
    ``engine="torch"``), its stepper state included (a ``StridedStepper``
    or ``WeightedPGMStepper`` one from ``step_stride``/``step_adapt``);
    every ``nmf_pgm_fused`` state (``engine="pallas"``: exact, strided,
    weighted, bfloat16 store; continued with ``engine="cuda"``); and both
    ``adaprox`` states, the driver's and the fused runner's (continued with
    ``nmf(algorithm="adaprox")`` on either engine, or
    ``adaprox(state=...)``), bfloat16 moments and the bfloat16 store
    included; the ``admm``/``sdmm`` state (continued with ``admm(state=...)``
    or ``sdmm(state=...)``) and the ``bsdmm`` state, a stateful stepper's
    included (continued with ``bsdmm(state=...)`` or
    ``nmf(algorithm="bsdmm", state=...)``); and both sharded states,
    ``nmf_pgm_sharded`` (every stride mode, the power iterate included) and
    ``nmf_adaprox_sharded``, on ``mesh`` with the solve's ``data_axis`` and
    ``model_axis``: every rank takes its slice of the sharded carries
    (continued with ``nmf_pgm_sharded``/``nmf_adaprox_sharded`` or
    ``nmf(mesh=...)``; the device is the mesh's). Other states raise
    ``NotImplementedError``.
    """
    kind = _py(state.get("kind"))
    if kind in ("nmf_pgm_sharded", "nmf_adaprox_sharded"):
        if mesh is not None:
            from .parallel.sharding import _local_device

            device = _local_device(mesh)
        return _sharded_state(state, kind, device, mesh, data_axis,
                              model_axis)
    device = default_device(device)
    if kind == "nmf_pgm_fused":
        return _fused_pgm_state(state, device)
    if kind is not None:
        raise NotImplementedError(
            f"no counterpart in the port for a {kind!r} state yet")
    if "M" in state:
        return _adaprox_state(state, device)
    if "slack" in state:
        return _admm_state(state, device)
    if "steps_state" in state:
        return _bsdmm_state(state, device)
    return _pgm_state(state, device)
