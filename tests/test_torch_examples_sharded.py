"""The port's sharded examples (``sharded_unmixing``, ``preemptible_resume``
and ``pod_serving`` of ``proxmin_tpu_torch.examples``) with ``--cpu`` on
two gloo ranks that each example starts itself, as ``tests/
test_examples.py`` runs their JAX twins on the 8-device virtual mesh: each
runs to its end with its own checks (iterate agreement at the short
horizon, the resumed trajectory and the program continuation bit for bit
against the uninterrupted live solve) and prints the line that test
looks for.
"""

import importlib


def _run(name, capsys, *args):
    module = importlib.import_module(f"proxmin_tpu_torch.examples.{name}")
    result = module.main(*args, cpu=True, ranks=2)
    return capsys.readouterr().out, result


def test_sharded_unmixing_example(capsys):
    """The auto-SPMD route, the explicit collectives and one device agree
    at 10 iterations (float32, 1e-2) and in their 300-iteration losses."""
    out, res = _run("sharded_unmixing", capsys)
    assert "all three paths agree" in out
    assert "devices: 2 x cpu" in out
    assert res["ranks"] == 2 and max(res["d12"], res["d13"]) < 1e-2


def test_preemptible_resume_example(capsys):
    """40 weighted adaptive iterations in slices of 17 through sharded
    checkpoints, every kill mid-segment: equal to the straight solve."""
    out, res = _run("preemptible_resume", capsys, 40, 17)
    assert "preempted trajectory == uninterrupted trajectory" in out
    assert res["dA"] == 0.0 and res["dS"] == 0.0
    assert out.count("checkpointed") == 3
    # every kill lands inside a refresh segment, before its end
    assert all(end > done for end, done in zip(res["seg_ends"],
                                                (17, 34, 40)))


def test_pod_serving_example(capsys):
    """Per-rank programs exported, saved, loaded and served: 30 fresh
    iterations, then 45 through the resume program equal the live 75."""
    out, res = _run("pod_serving", capsys)
    assert "bit-exact vs live" in out
    assert (res["it_preempted"], res["it"], res["dS"]) == (30, 75, 0.0)
