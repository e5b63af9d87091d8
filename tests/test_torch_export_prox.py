"""Exported fused NMF programs with any prox_S: a compiled chain goes into
the program as K1's or K2's codes; any other traceable prox is traced
between the kernels' two split passes; an untraceable one raises.

Each program is held against the port's driver on the same inputs, bit for
bit (the program runs the driver's body, with the kernels as registered ops
whose CPU implementation is the drivers' plain version), and the chain's
against JAX's program with the same prox at test_torch_export.py's float32
tolerance (rtol 1e-3, atol 1e-5: float32 sums over the pixels in other
orders, compounded over 12 iterations)."""

import functools
import io

import numpy as np
import pytest
import torch

import proxmin_tpu as pt
import proxmin_tpu.export as jex
import proxmin_tpu_torch as ptt
import proxmin_tpu_torch.export as tex

C, K, N, TILE, ITERS = 4, 3, 256, 128, 12
F32 = dict(rtol=1e-3, atol=1e-5)
P = functools.partial


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    return Y, W, A0, S0


def _simplex_closure(x, s):
    return ptt.operators.prox_unity_plus(x, s, axis=0)


def _ops_called(blob):
    ep = torch.export.load(io.BytesIO(blob))
    return {getattr(n.target, "__name__", "").split(".")[0]
            for m in ep.graph_module.modules()
            if isinstance(m, torch.fx.GraphModule)
            for n in m.graph.nodes if n.op == "call_function"}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("prox,ops", [
    (P(ptt.operators.prox_unity_plus, axis=0), {"fused_nmf_pgm_step"}),
    (_simplex_closure, {"fused_nmf_pgm_pass1", "fused_nmf_pgm_pass2"}),
], ids=["chain", "split"])
def test_pgm_program_with_any_prox_equals_the_driver(weighted, prox, ops):
    Y, W, A0, S0 = _problem()
    kw = dict(weighted=True, step_stride=4) if weighted else {}
    blob = tex.export_nmf_solver(C, K, N, prox_S=prox, e_rel=0.0,
                                 tile_n=TILE, device="cpu", **kw)
    assert ops <= _ops_called(blob)
    data = (A0, S0, Y) + ((W,) if weighted else ())
    got = tex.load_solver(blob)(*data, ITERS)
    res = ptt.nmf.nmf_pgm_fused(Y, A0.copy(), S0.copy(),
                                W=W if weighted else None, prox_S=prox,
                                e_rel=0, max_iter=ITERS, tile_n=TILE,
                                step_stride=kw.get("step_stride"),
                                device="cpu")
    for g, w in zip(got[:2], res.x):
        assert torch.equal(g, w)
    np.testing.assert_allclose(got[1].numpy().sum(0), 1.0, rtol=1e-5)


def test_pgm_chain_program_matches_jax():
    Y, _, A0, S0 = _problem(2)
    got = tex.load_solver(tex.export_nmf_solver(
        C, K, N, prox_S=P(ptt.operators.prox_soft_plus, thresh=0.5),
        e_rel=0.0, tile_n=TILE, device="cpu"))(A0, S0, Y, ITERS)
    want = jex.load_solver(jex.export_nmf_solver(
        C, K, N, prox_S=P(pt.operators.prox_soft_plus, thresh=0.5),
        e_rel=0.0, tile_n=TILE))(A0, S0, Y, ITERS)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


@pytest.mark.parametrize("prox,ops", [
    (P(ptt.operators.prox_soft_plus, thresh=0.1), {"fused_nmf_adaprox_step"}),
    (P(ptt.operators.prox_max_entropy, gamma=0.1),
     {"fused_nmf_adaprox_pass1", "fused_nmf_adaprox_pass2"}),
], ids=["chain", "split"])
def test_adaprox_program_with_any_separable_prox_equals_the_driver(prox,
                                                                    ops):
    Y, _, A0, S0 = _problem(1)
    blob = tex.export_nmf_adaprox_solver(C, K, N, prox_S=prox, e_rel=0.0,
                                         tile_n=TILE, device="cpu")
    assert ops <= _ops_called(blob)
    got = tex.load_solver(blob)(A0, S0, Y, ITERS)
    res = ptt.nmf.nmf_adaprox_fused(Y, A0.copy(), S0.copy(), prox_S=prox,
                                    e_rel=0, max_iter=ITERS, tile_n=TILE,
                                    device="cpu")
    for g, w in zip(got[:2], res.x):
        assert torch.equal(g, w)


def test_untraceable_prox_raises_naming_it():
    """A prox that branches on a tensor's value cannot be captured: the
    exporter raises ValueError naming it (EXPORT_GAPS in
    tests/test_torch_api_surface.py)."""
    def branching(x, s):
        return x if bool((x > 0).all()) else ptt.operators.prox_plus(x, s)

    with pytest.raises(ValueError, match="prox_S=.*branching"):
        tex.export_nmf_solver(C, K, N, prox_S=branching, e_rel=0.0,
                              tile_n=TILE, device="cpu")
