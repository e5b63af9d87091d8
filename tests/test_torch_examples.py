"""The port's single-process examples (``proxmin_tpu_torch.examples``) on
the CPU, against the JAX scripts of ``examples/``.

Each port example runs with ``--cpu``'s ``main(cpu=True)`` at the toy
arguments that ``tests/test_examples.py`` gives its JAX twin, keeps the
script's own checks (it raises if one fails) and prints the lines that
test asserts. The parity tests run the JAX script through ``runpy`` at the
same arguments (float64 where the script's data are NumPy float64, as
``tests/conftest.py`` enables x64), parse the numbers it prints and hold the
port's ``main`` dict to them. A printed number is rounded: each comparison
allows half a unit of its last printed digit, plus the slack stated at the
case. The sharded three are in ``test_torch_examples_sharded.py``.
"""

import contextlib
import importlib
import io
import math
import pathlib
import re
import runpy
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

# name -> (positional arguments, substrings the output holds, {substring:
# count} it holds exactly so often), as tests/test_examples.py asserts them
CASES = {
    "parabola": ((), ("SDMM", "FISTA"), {}),
    "tv_denoise": ((4096,), ("RMSE",), {}),
    "image_tv": ((64,), ("RMSE",), {}),
    "unmixing": ((), (), {"match = 0.9": 4}),
    "astro_unmixing": ((), ("weighted (W = 1/sky)",), {"weighted loss": 5}),
    "batched_solves": ((64,), ("64 solves in one call",
                               "match individual solves"), {}),
    "learn_regularizer": ((), ("learned wins",), {}),
    "fused_adam_unmixing": ((1024,), ("fused adam", "continued"), {}),
}
_RUNS = {}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def port_run(name):
    """``(stdout, dict)`` of the port example's ``main`` on the CPU at the
    case's arguments, run once per test process."""
    if name not in _RUNS:
        module = importlib.import_module(f"proxmin_tpu_torch.examples.{name}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = module.main(*CASES[name][0], cpu=True)
        _RUNS[name] = (buf.getvalue(), out)
    return _RUNS[name]


def jax_run(name, monkeypatch):
    """The JAX script's output at the case's arguments."""
    monkeypatch.setattr(sys, "argv",
                        [f"{name}.py", *map(str, CASES[name][0])])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                       run_name="__main__")
    return buf.getvalue()


def near(got, printed, slack=0.0, rel=0.0):
    """``got`` equals the printed number within half a unit of its last
    digit, ``slack`` and ``rel`` times its size."""
    s = printed.strip()
    mant = s.lower().split("e")[0]
    decimals = len(mant.split(".")[1]) if "." in mant else 0
    exp = int(s.lower().split("e")[1]) if "e" in s.lower() else 0
    half = 0.5 * 10.0 ** (exp - decimals)
    want = float(s)
    return math.isclose(got, want, rel_tol=0, abs_tol=half + slack
                        + rel * abs(want))


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_example_runs_on_the_cpu(name):
    """The example runs to its end with its own checks and prints what the
    JAX script's smoke test looks for."""
    out, result = port_run(name)
    _, holds, counts = CASES[name]
    for line in holds:
        assert line in out, (line, out)
    for line, n in counts.items():
        assert out.count(line) >= n, (line, out)
    assert isinstance(result, dict) and result


NUM = r"(-?[0-9.]+(?:e[-+]?[0-9]+)?)"


def test_parabola_matches_the_jax_script(monkeypatch):
    """Every solver on the 2-vector: each reduction adds two numbers, so
    both libraries compute the same floats in float64; the iteration counts
    are equal and x and its distance to the optimum agree to the printed
    digits (and 1e-12, rounding noise, on distances near zero)."""
    printed = jax_run("parabola", monkeypatch)
    port = port_run("parabola")[1]
    rows = re.findall(r"^(.+?)\s+x = \(\s*" + NUM + r",\s*" + NUM
                      + r"\)\s+\|x - x\*\| = " + NUM + r"\s+iters = (\d+)",
                      printed, re.M)
    assert len(rows) == len(port) == 12
    for label, x0, x1, err, iters in rows:
        got = port[label.strip()]
        assert got["iters"] == int(iters), label
        assert near(got["x"][0], x0) and near(got["x"][1], x1), label
        assert near(got["err"], err, slack=1e-12), label


@pytest.mark.parametrize("name", ["tv_denoise", "image_tv"])
def test_tv_examples_match_the_jax_scripts(name, monkeypatch):
    """The TV denoisings in float32 to their iteration caps: the iterates
    are elementwise operations and differences (only the stopping norms
    sum), so the TV and the RMSE agree to the printed digits, with float32
    rounding's 1e-5 relative on the TV sums over all samples."""
    printed = jax_run(name, monkeypatch)
    port = port_run(name)[1]
    iters = int(re.search(r"iters=(\d+)", printed).group(1))
    tv_in, tv_out = re.search(r"TV:\s+\w+\s+" + NUM + r"\s+->\s+\w+\s+"
                              + NUM, printed).groups()
    r_in, r_out = re.search(r"RMSE:\s+\w+\s+" + NUM + r"\s+->\s+\w+\s+"
                            + NUM, printed).groups()
    assert port["iters"] == iters
    assert near(port["tv_in"], tv_in, rel=1e-5)
    assert near(port["tv_out"], tv_out, rel=1e-5)
    assert near(port["rmse_in"], r_in) and near(port["rmse_out"], r_out)


@pytest.mark.parametrize("name", ["unmixing", "astro_unmixing"])
def test_nmf_races_match_the_jax_scripts(name, monkeypatch):
    """The NMF races in float64: the stopping iteration of a run that
    converges (e_rel 1e-4 and 1e-3 on a nonconvex problem, the matrix
    products summed in another order) within 2; the final losses within
    1e-4 relative of the printed ones (a sweep or two at the stopping
    tolerance); the Hungarian-matched correlations to the printed digits
    and 1e-4."""
    printed = jax_run(name, monkeypatch)
    port = port_run(name)[1]
    if name == "unmixing":
        rows = re.findall(r"^(.+?)\s+loss =\s+" + NUM + r"\s+iters =\s+"
                          r"(\d+)\s+match = " + NUM, printed, re.M)
    else:
        rows = [r + (None,) for r in re.findall(
            r"^(.+?)\s+weighted loss =\s+" + NUM + r"\s+iters =\s+(\d+)",
            printed, re.M)]
    assert len(rows) == len(port) == (4 if name == "unmixing" else 5)
    for label, loss, iters, match in rows:
        got = port[label.strip()]
        assert abs(got["iters"] - int(iters)) <= 2, label
        assert near(got["loss"], loss, rel=1e-4), label
        if match is not None:
            assert near(got["match"], match, slack=1e-4), label


def test_batched_solves_matches_the_jax_script(monkeypatch):
    """64 float32 lanes: the per-lane iteration counts' minimum, median and
    maximum within 2 (the script's own allowance for float32 reductions
    that round otherwise in a batch), and every lane converges in both."""
    printed = jax_run("batched_solves", monkeypatch)
    port = port_run("batched_solves")[1]
    lo, med, hi, conv, batch = map(int, re.search(
        r"min (\d+), median (\d+), max (\d+); (\d+)/(\d+) converged",
        printed).groups())
    assert batch == port["batch"] == 64
    assert abs(port["it_min"] - lo) <= 2 and abs(port["it_max"] - hi) <= 2
    assert abs(port["it_median"] - med) <= 2
    assert port["converged"] == conv == 64


def test_learn_regularizer_matches_the_jax_script(monkeypatch):
    """The bilevel descent in float64: 150 outer steps on implicit
    gradients solved to 1e-9, so the losses and the learned strength agree
    to the printed digits and 1e-6."""
    printed = jax_run("learn_regularizer", monkeypatch)
    port = port_run("learn_regularizer")[1]
    l0, l1, lam = re.search(r"outer loss " + NUM + r" -> " + NUM
                            + r" \(learned lam = " + NUM, printed).groups()
    weak, strong = re.search(r"weak " + NUM + r", strong " + NUM,
                             printed).groups()
    for key, s in (("l0", l0), ("l1", l1), ("lam", lam), ("weak", weak),
                   ("strong", strong)):
        assert near(port[key], s, slack=1e-6), key


def test_fused_adam_unmixing_matches_the_jax_script(monkeypatch):
    """K2's plain version against JAX's fused engine, and the two drivers:
    float32 with bfloat16 moments over 150 + 150 iterations, the losses
    within 1e-3 relative of the printed ones (a bfloat16 rounding of a
    moment may flip where the float32 sums differ in their last bit)."""
    printed = jax_run("fused_adam_unmixing", monkeypatch)
    port = port_run("fused_adam_unmixing")[1]
    l0, l1, its = re.search(r"fused adam: loss " + NUM + r" -> " + NUM
                            + r" after (\d+)", printed).groups()
    cont = re.search(r"continued:\s+loss " + NUM + r" -> " + NUM,
                     printed).group(2)
    drv = re.search(r"driver: loss " + NUM + r" -> " + NUM,
                    printed).group(2)
    assert port["fused_iters"] == int(its) == 150
    assert near(port["loss0"], l0, rel=1e-6)
    for key, s in (("fused", l1), ("continued", cont), ("driver", drv)):
        assert near(port[key], s, rel=1e-3), key


def test_the_port_has_every_example():
    """One module per JAX script, under its name."""
    from proxmin_tpu_torch import examples

    scripts = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
    assert sorted(examples.NAMES) == scripts
    for name in scripts:
        assert callable(importlib.import_module(
            f"proxmin_tpu_torch.examples.{name}").main)


@pytest.mark.parametrize("name", ["parabola", "tv_denoise", "image_tv",
                                  "unmixing", "astro_unmixing",
                                  "batched_solves", "learn_regularizer",
                                  "fused_adam_unmixing", "sharded_unmixing",
                                  "preemptible_resume", "pod_serving"])
def test_an_example_without_a_card_raises(name, monkeypatch):
    """Without a card and without ``--cpu`` an example raises before it
    does anything; it never falls back to the CPU."""
    module = importlib.import_module(f"proxmin_tpu_torch.examples.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        module.main()
