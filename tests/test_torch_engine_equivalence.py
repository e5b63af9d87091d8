"""The engine-equivalence contract of ``nmf(engine="auto")`` in the port:
the torch engine and the cuda engine (on CPU tensors, K1's and K2's plain
versions) reach the same converged quality at the same tolerance, possibly
by another path.

The configurations, the problems, the float64 loss oracle and the
acceptance bound are those of ``benchmarks/engine_equivalence.py``
(``CPU_CONFIGS``, ``make_problem``, ``loss_f64``, ``summarize``,
``check_equivalence``, ``ACCEPTANCE``: NumPy only); the JAX engines' names
map to the port's (``xla`` -> ``torch``, ``pallas`` -> ``cuda``), and the
``unity_A`` proxes are the port's operators. Each configuration runs
``SEEDS`` seeds through every engine to its tolerance.
"""

import os
import sys
from functools import partial

import numpy as np
import pytest
import torch

import proxmin_tpu_torch as ptt

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "benchmarks"))

from engine_equivalence import (  # noqa: E402
    ACCEPTANCE,
    CPU_CONFIGS,
    check_equivalence,
    loss_f64,
    make_problem,
    summarize,
)

SEEDS = 10
BASELINE = "torch"


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _engines(cfg):
    """The configuration's engines under the port's names and options."""
    out = {}
    for name, kw in cfg["engines"].items():
        kw = dict(kw)
        kw["engine"] = {"xla": "torch", "pallas": "cuda"}[kw["engine"]]
        out[name.replace("xla", "torch").replace("pallas", "cuda")] = kw
    return out


def _proxes(cfg):
    if cfg.get("prox", "unity_A") == "unity_A":
        return partial(ptt.operators.prox_unity_plus, axis=1), \
            ptt.operators.prox_plus
    return ptt.operators.prox_plus, ptt.operators.prox_plus


def _run(cfg, kw, problem):
    Y, A0, S0, W = problem
    prox_A, prox_S = _proxes(cfg)
    res = ptt.nmf.nmf(Y, A0.copy(), S0.copy(), W=1 if W is None else W,
                      prox_A=prox_A, prox_S=prox_S,
                      algorithm=cfg["algorithm"], e_rel=cfg["e_rel"],
                      max_iter=cfg["max_iter"], device="cpu", **kw)
    A, S = (x.numpy() for x in res.x)
    return {"iterations": int(res.iterations),
            "converged": bool(all(res.converged)),
            "loss": loss_f64(A, S, Y, W)}


@pytest.mark.parametrize("name", sorted(CPU_CONFIGS))
def test_engines_equivalent_at_convergence(name):
    cfg = CPU_CONFIGS[name]
    engines = _engines(cfg)
    rows = {eng: [] for eng in engines}
    for i in range(SEEDS):
        problem = make_problem(cfg["C"], cfg["K"], cfg["N"], 1000 + i,
                               weighted=cfg["weighted"],
                               planted=cfg["planted"])
        for eng, kw in engines.items():
            rows[eng].append(_run(cfg, kw, problem))
    stats = {eng: summarize(r) for eng, r in rows.items()}
    # the configurations are chosen to converge: first hold the baseline
    assert stats[BASELINE]["conv_rate"] >= 0.9, stats[BASELINE]
    verdicts = check_equivalence(stats, BASELINE, ACCEPTANCE)
    bad = {e: v for e, v in verdicts.items() if not v["ok"]}
    assert not bad, (f"engine(s) {sorted(bad)} violate the equivalence "
                     f"bound vs torch on {name}: {bad}; stats={stats}")
