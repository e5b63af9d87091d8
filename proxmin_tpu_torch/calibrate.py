"""One-shot runtime engine calibration for ``nmf(engine='auto')``.

Counterpart of :mod:`proxmin_tpu.calibrate`. The static routing regions
(``nmf._unweighted_fused_wins``, ``_unweighted_strided_fused_wins``,
``_weighted_fused_wins``, ``_adaprox_fused_wins``) come from one sweep of
``tools/engine_sweep.py`` on one card. Where that sweep found the two
engines within its own spread of each other, a measurement from one host
and card does not carry to another: there, the first auto-routed PGM solve
of a given ``(device kind, C, K, N, weighted, policy, dtype, e_rel)`` times
a few marginal iterations of each engine through the real ``nmf`` entry
and caches the winner in-process and on disk (keyed by the device kind, so
one card's decision never routes another). Far from those shapes the
static regions are used directly. Probing is switched off by
``set_auto_calibration('off')`` or ``PROXMIN_TPU_TORCH_AUTOTUNE=0``; the
disk cache lives at ``PROXMIN_TPU_TORCH_AUTOTUNE_CACHE`` (default
``~/.cache/proxmin_tpu_torch/routing.json``, a file of its own beside the
JAX package's).

Three deliberate differences from the JAX module:

- the key holds the caller's ``e_rel``, and a decision whose probe
  converged inside its budget is not cached (both engines then stop early
  alike, and their times measure nothing);
- a marginal clipped to zero or below is no measurement: the static choice
  stands and nothing is cached;
- a probe that raises is not swallowed: a kernel that fails to build or to
  launch reaches the caller instead of turning into a quiet torch route.
"""

import json
import logging
import os
import time

logger = logging.getLogger("proxmin")

#: 'on' — probe inside the gray zone, static regions elsewhere.
#: 'off' — static regions everywhere (no probing).
_MODE = ("off" if os.environ.get("PROXMIN_TPU_TORCH_AUTOTUNE") == "0"
         else "on")

_CACHE = {}          # key tuple -> engine name (in-process)
_DISK_LOADED = False
_DISK = {}           # "key string" -> {"engine": ..., "ms_per_iter": {...}}

#: How far the measured gray ranges are widened along N, a factor each
#: way. 1: the ranges as the sweep drew them from its own spread (the JAX
#: module's 4 covered a TPU pool's run-to-run swing around a VMEM cliff).
GRAY_FACTOR = 1.0

PROBE_ITERS = (10, 60)  # marginal over 50 iterations
PROBE_REPS = 3          # least of three: the host clock's spread
NEAR_TIE = 0.05         # within 5%: keep the static-region choice


def set_auto_calibration(mode):
    """``'on'`` (default) or ``'off'``. Returns the previous mode. 'off'
    restores pure static routing (no probing, no cache lookups)."""
    global _MODE
    if mode not in ("on", "off"):
        raise ValueError(f"mode must be 'on' or 'off', got {mode!r}")
    prev = _MODE
    _MODE = mode
    return prev


def clear_cache():
    """Drop in-process calibration decisions (disk cache untouched)."""
    _CACHE.clear()


def _disk_path():
    return os.environ.get(
        "PROXMIN_TPU_TORCH_AUTOTUNE_CACHE",
        os.path.expanduser("~/.cache/proxmin_tpu_torch/routing.json"))


def _load_disk():
    global _DISK_LOADED, _DISK
    if _DISK_LOADED:
        return _DISK
    _DISK_LOADED = True
    try:
        with open(_disk_path()) as f:
            _DISK = json.load(f)
    except (OSError, ValueError):
        _DISK = {}
    return _DISK


def _save_disk():
    path = _disk_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(_DISK, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # the cache is an optimization only (read-only file system)


def device_kind(device=None):
    """The name of the card a solve runs on
    (``torch.cuda.get_device_name``), or ``"cpu"``."""
    import torch

    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda":
        return device.type
    return torch.cuda.get_device_name(device)


def in_gray_zone(C, K, N, weighted, strided):
    """Is this shape close enough to a crossover of the static regions that
    the card's and the host's spread could flip the decision? True inside
    the N range that ``tools/engine_sweep.py`` drew around the crossover of
    the region that routes the call (``nmf._H100_REGIONS``: exact, stride
    10 or weighted), widened by ``GRAY_FACTOR``. Where the sweep found no
    crossover along N for the covering swept (C, K) (one engine the faster
    at every N), there is no band."""
    from .nmf import _gray_range

    path = ("pgm-w-stride10" if weighted
            else "pgm-stride10" if strided else "pgm-exact")
    gray = _gray_range(path, C, K)
    return (gray is not None
            and gray[0] / GRAY_FACTOR <= N <= gray[1] * GRAY_FACTOR)


def measured_choice(key, probes, fallback, iters=PROBE_ITERS,
                    reps=PROBE_REPS, _timer=time.perf_counter):
    """Pick the faster engine by timing short fixed-iteration runs.

    ``probes``: ``{engine_name: callable(max_iter)}``; each runs a
    fixed-iteration solve through the real engine path and waits for the
    device, and may return the iterations it ran. ``fallback``: the static
    choice, returned when calibration is off and when the probes measure
    nothing (a probe that converged inside its budget, a marginal at or
    below zero); neither case is cached. A probe that raises propagates.
    ``_timer`` is injectable for tests.
    """
    if _MODE != "on":
        return fallback
    if key in _CACHE:
        return _CACHE[key]
    disk = _load_disk()
    skey = "|".join(str(p) for p in key)
    hit = disk.get(skey)
    if isinstance(hit, dict) and hit.get("engine") in probes:
        _CACHE[key] = hit["engine"]
        return hit["engine"]
    lo, hi = iters
    marginals = {}
    converged = False
    for name, fn in probes.items():
        fn(lo)  # build and warm the engine outside the timing
        t_lo, t_hi = [], []
        for _ in range(reps):
            for n, into in ((lo, t_lo), (hi, t_hi)):
                t, ran = _timed(fn, n, _timer)
                converged |= ran is not None and ran < n
                into.append(t)
        marginals[name] = (min(t_hi) - min(t_lo)) / (hi - lo)
    ms = {k: round(v * 1e3, 5) for k, v in marginals.items()}
    if converged or min(marginals.values()) <= 0.0:
        logger.info("auto-calibration %s measured nothing (%s); static "
                    "routing (%s)", skey, "a probe converged" if converged
                    else f"marginals {ms} ms/iter", fallback)
        return fallback
    best = min(marginals, key=marginals.get)
    # near-tie: never overrule the static regions on noise
    if (fallback in marginals and best != fallback
            and marginals[fallback] <= marginals[best] * (1.0 + NEAR_TIE)):
        best = fallback
    logger.info("auto-calibration %s: %s (measured %s ms/iter)", skey, best,
                ms)
    _CACHE[key] = best
    _DISK[skey] = {"engine": best, "ms_per_iter": ms}
    _save_disk()
    return best


def _timed(fn, n, _timer):
    t0 = _timer()
    ran = fn(n)
    return _timer() - t0, ran
