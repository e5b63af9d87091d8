"""K1's plain version against the JAX fused_nmf_pgm_step.

The JAX kernel runs as tests/test_pallas_ops.py runs it on the CPU: the
problem padded with pad_nmf_problem, the Pallas interpreter, the outputs
cropped to [:C, :K] / [:K, :N]. Tolerance rtol 2e-4, atol 1e-5 (the
statistics rtol 1e-3), as in test_pallas_ops.py: both compute in float32
but sum the pixel-axis reductions in different orders.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import re

import numpy as np
import pytest
import torch

from proxmin_tpu.ops.nmf_kernels import (fused_nmf_pgm_step as jax_step,
                                         pad_nmf_problem)
from proxmin_tpu import operators as jop
import proxmin_tpu_torch.ops._build as kb
import proxmin_tpu_torch.ops.nmf_kernels as k1
from proxmin_tpu_torch import operators as top


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _problem(rng, C, K, N, weighted):
    A = rng.random((C, K)).astype(np.float32)
    S = rng.random((K, N)).astype(np.float32)
    Y = rng.random((C, N)).astype(np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32) if weighted else None
    return A, S, Y, W


@pytest.mark.parametrize("C,K,N", [(5, 7, 700), (8, 4, 1000), (3, 2, 129)])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("prox", ["plus", "id"])
def test_plain_version_matches_jax_kernel(rng, C, K, N, weighted, prox):
    A, S, Y, W = _problem(rng, C, K, N, weighted)
    sS = 0.05
    A_p, S_p, Y_p, W_p, dims, tile = pad_nmf_problem(A, S, Y, W, tile_n=256)
    want = jax_step(A_p, S_p, Y_p, sS, W=W_p, tile_n=tile, dims=dims,
                    prox_S=None if prox == "plus" else jop.prox_id)
    gA_j, S_j, G_j = (np.asarray(want[0])[:C, :K], np.asarray(want[1])[:K, :N],
                      np.asarray(want[2])[:K, :K])

    got = k1.fused_nmf_pgm_step(
        torch.from_numpy(A), torch.from_numpy(S), torch.from_numpy(Y),
        torch.tensor(sS), W=None if W is None else torch.from_numpy(W),
        prox_S=None if prox == "plus" else top.prox_id)
    assert all(t.dtype == torch.float32 for t in got)
    np.testing.assert_allclose(got[0].numpy(), gA_j, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), S_j, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), G_j, rtol=2e-4, atol=1e-5)
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-3)


def test_cpu_tensors_take_the_plain_version(rng):
    """On CPU tensors the wrapper is the plain version, bit for bit, and
    counts no kernel launch."""
    A, S, Y, _ = (torch.from_numpy(a) if a is not None else None
                  for a in _problem(rng, 5, 7, 300, False))
    before = k1.fused_nmf_pgm_step.launches
    got = k1.fused_nmf_pgm_step(A, S, Y, 0.03)
    ref = k1.fused_nmf_pgm_step_reference(A, S, Y, 0.03)
    assert k1.fused_nmf_pgm_step.launches == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_plain_version_applies_any_prox(rng):
    """Off the card the plain version takes any prox callable."""
    A, S, Y, _ = (torch.from_numpy(a) if a is not None else None
                  for a in _problem(rng, 4, 3, 200, False))

    def prox(x, s):
        return top.prox_unity_plus(x, s, axis=0)

    S_new = k1.fused_nmf_pgm_step(A, S, Y, 0.05, prox_S=prox)[1]
    np.testing.assert_allclose(S_new.sum(0).numpy(), 1.0, rtol=1e-6)


def test_kernel_prox_set_is_closed():
    """Every prox_S reaches K1: the builtins and the library's per-column
    operators as compiled chains, anything else as the split path; none
    raises."""
    assert k1.describe_prox(None).ops == (k1._PLUS,)
    assert k1.describe_prox(top.prox_plus).ops == (k1._PLUS,)
    assert k1.describe_prox(top.prox_id).ops == ()
    assert k1.describe_prox(top.prox_soft).ops == (k1._SOFT | k1._RELATIVE,)
    assert k1.describe_prox(lambda x, s: x).split


def test_wrapper_refuses_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA card raises
    instead of silently running somewhere else."""
    A = torch.empty((5, 7), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        k1.fused_nmf_pgm_step(A, A, A, 0.1)


def test_build_inputs_are_in_the_checkout():
    """Each kernel is built from the package's own source into a library
    of its own in the gitignored build directory of the checkout (K2's
    very-wide instances from K2's wide source, with K_WIDE defined for the
    residual modes past K = 32 up to 128 and VERY_WIDE for the rest)."""
    assert set(kb._SOURCES) == {"nmf_pgm_step", "nmf_pgm_wide",
                                "nmf_adaprox_step", "nmf_adaprox_wide",
                                "nmf_adaprox_kwide", "nmf_adaprox_vwide",
                                "nmf_grad", "prox_elementwise"}
    for name, define in (("nmf_adaprox_kwide", "K_WIDE"),
                         ("nmf_adaprox_vwide", "VERY_WIDE")):
        assert kb._SOURCES[name] == kb._SOURCES["nmf_adaprox_wide"]
        assert kb._DEFINES[name] == (define,)
        assert kb._library_path(name) != kb._library_path("nmf_adaprox_wide")
    assert (kb._library_path("nmf_adaprox_kwide")
            != kb._library_path("nmf_adaprox_vwide"))
    for name, src in kb._SOURCES.items():
        assert src.is_file() and src.parent.name == "csrc"
        assert kb._library_path(name).name.startswith(f"{name}-")
        assert kb._library_path(name).parent == kb._BUILD_DIR
        assert kb._DECLARE[name]
        assert all(callable(d) for d in kb._DECLARE[name])
    root = kb._BUILD_DIR.parents[1]
    assert (root / "proxmin_tpu_torch").is_dir()
    ignored = (root / ".gitignore").read_text().split()
    assert "build/" in ignored
    assert "sm_90a" in " ".join(kb._NVCC_FLAGS)


def test_tier_bounds_match_the_kernels():
    """The host's component bounds of the tiers are the kernels' own
    (csrc/tiers.cuh), which pick the body each pass runs on."""
    text = (kb._SOURCES["nmf_grad"].parent / "tiers.cuh").read_text()
    bounds = dict(re.findall(r"constexpr int (k\w+K) = (\d+);", text))
    assert bounds == {"kWideK": str(k1.WIDE_K), "kKwideK": str(k1.KWIDE_K),
                      "kPanelK": str(k1.PANEL_K)}


def test_library_hash_covers_only_its_own_source(tmp_path, monkeypatch):
    """A library's name hashes its own source text (beside the headers and
    the flags), so a change to one kernel source rebuilds that kernel
    alone."""
    before = {n: kb._library_path(n) for n in kb._SOURCES}
    edited = tmp_path / "nmf_grad.cu"
    edited.write_text(kb._SOURCES["nmf_grad"].read_text() + "// edit\n")
    monkeypatch.setitem(kb._SOURCES, "nmf_grad", edited)
    after = {n: kb._library_path(n) for n in kb._SOURCES}
    assert after["nmf_grad"] != before["nmf_grad"]
    assert all(after[n] == before[n] for n in before if n != "nmf_grad")


def test_library_hash_covers_the_headers(tmp_path, monkeypatch):
    """Every csrc/*.cuh is folded into every library's hash: an edit to a
    header (the kernels include bulk_ring.cuh and pgm_pass.cuh) changes the
    library path, so no stale library built from the old header is
    loaded; a file of another kind in the directory changes nothing."""
    headers = sorted(kb.CSRC.glob("*.cuh"))
    assert {h.name for h in headers} >= {"bulk_ring.cuh", "pgm_pass.cuh"}
    for h in headers:
        (tmp_path / h.name).write_bytes(h.read_bytes())
    monkeypatch.setattr(kb, "CSRC", tmp_path)
    same = {n: kb._library_path(n) for n in kb._SOURCES}
    monkeypatch.undo()
    assert same == {n: kb._library_path(n) for n in kb._SOURCES}
    monkeypatch.setattr(kb, "CSRC", tmp_path)
    (tmp_path / "notes.txt").write_text("not a header\n")
    assert {n: kb._library_path(n) for n in kb._SOURCES} == same
    ring = tmp_path / "bulk_ring.cuh"
    ring.write_text(ring.read_text() + "// edit\n")
    edited = {n: kb._library_path(n) for n in kb._SOURCES}
    assert all(edited[n] != same[n] for n in same)
    (tmp_path / "extra.cuh").write_text("#pragma once\n")
    assert all(kb._library_path(n) != edited[n] for n in same)
