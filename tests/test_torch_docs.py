"""The port's own docs (proxmin_tpu_torch/docs/): API.md names every public
name of the port, and every fenced ``python`` block of the four files
parses and imports neither JAX nor the JAX package. The blocks of API.md
also run, on the CPU."""

import ast
import importlib
import pathlib
import pkgutil
import re

import pytest
import torch

import proxmin_tpu_torch

DOCS = pathlib.Path(proxmin_tpu_torch.__file__).parent / "docs"
FILES = ("API.md", "DESIGN.md", "SERVING.md", "PARITY.md")
FENCE = re.compile(r"^```python\n(.*?)^```", re.S | re.M)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _modules():
    """Every module of the port that declares ``__all__``."""
    names = ["proxmin_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(proxmin_tpu_torch.__path__,
                                              "proxmin_tpu_torch.")]
    return sorted(n for n in names
                  if hasattr(importlib.import_module(n), "__all__"))


def _blocks(name):
    return FENCE.findall((DOCS / name).read_text())


def test_the_four_docs_exist():
    assert all((DOCS / f).is_file() for f in FILES)
    assert all(_blocks(f) or f == "PARITY.md" for f in FILES)


def test_api_names_the_top_level():
    """The top level's public names: the solvers, the operators, the
    submodules and the precision policy."""
    text = (DOCS / "API.md").read_text()
    public = [n for n in dir(proxmin_tpu_torch) if not n.startswith("_")]
    assert [n for n in public if f"`{n}`" not in text] == []


@pytest.mark.parametrize("module", _modules())
def test_api_names_every_public_name(module):
    text = (DOCS / "API.md").read_text()
    names = importlib.import_module(module).__all__
    assert f"`{module}`" in text
    assert [n for n in names if f"`{n}`" not in text] == []


@pytest.mark.parametrize("name", FILES)
def test_code_blocks_parse_and_import_no_jax(name):
    for block in _blocks(name):
        tree = ast.parse(block)
        imported = [a.name for n in ast.walk(tree)
                    if isinstance(n, ast.Import) for a in n.names]
        imported += [n.module or "" for n in ast.walk(tree)
                     if isinstance(n, ast.ImportFrom)]
        assert not [m for m in imported
                    if m.split(".")[0] in ("jax", "jaxlib", "proxmin_tpu")]


def test_api_blocks_run_on_the_cpu():
    for block in _blocks("API.md"):
        exec(compile(block, "API.md", "exec"), {})
