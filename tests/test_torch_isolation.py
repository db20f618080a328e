"""The port stands alone: no JAX, no ``quant_tpu``, the card by default.

* An ``ast`` scan of ``quant_tpu_torch/**/*.py`` and ``chip_smoke.py`` finds
  no import of ``jax``, ``jaxlib`` or ``quant_tpu`` (other than
  ``quant_tpu_torch``), and none of ``safetensors`` or ``transformers``
  (packages the card's machine lacks) but two: ``transformers`` inside
  ``tokens_from_file`` and the CLI's ``_tokenizer``, for an explicit
  ``--tokenizer``.
* A subprocess imports every module of the port with ``jax`` blocked.
* Entry points called without ``device="cpu"`` raise on a machine without a
  GPU instead of falling back to the CPU.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "quant_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "quant_tpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread runs them as fast and
    leaves the other cores to the test processes beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _imported(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in FORBIDDEN


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imported(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


# packages the card's machine lacks: (file, function) that may import them
OPTIONAL = {"safetensors": set(),
            "transformers": {("quant_tpu_torch/eval/perplexity.py",
                              "tokens_from_file"),
                             ("quant_tpu_torch/cli.py", "_tokenizer")}}


def _optional_imports(path: pathlib.Path) -> list[tuple[str, str]]:
    """(package, enclosing function or "<module>") of each import of an
    ``OPTIONAL`` package in ``path``."""
    found = []

    def visit(node, where):
        for child in ast.iter_child_nodes(node):
            inner = (child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else where)
            names = []
            if isinstance(child, ast.Import):
                names = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.module:
                names = [child.module]
            found.extend((n.split(".")[0], where) for n in names
                         if n.split(".")[0] in OPTIONAL)
            visit(child, inner)
    visit(ast.parse(path.read_text(), str(path)), "<module>")
    return found


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_safetensors_or_transformers_imports(path):
    rel = str(path.relative_to(REPO))
    bad = [(pkg, fn) for pkg, fn in _optional_imports(path)
           if (rel, fn) not in OPTIONAL[pkg]]
    assert not bad, f"{rel} imports {bad}"


def test_port_imports_with_jax_blocked():
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "quant_tpu_torch").rglob("*.py")
        if p.name != "__main__.py")
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['jaxlib'] = None\n"
            "sys.modules['quant_tpu'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m.removesuffix('.__init__'))\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the card default is usable")
    from quant_tpu_torch.checkpoint import load_checkpoint
    from quant_tpu_torch.engine import Engine
    from quant_tpu_torch.models import PRESETS, llama

    cfg = PRESETS["test-tiny"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_cache(cfg, 1, 16)
    params = llama.init_params(cfg, seed=0, device="cpu")
    cache = llama.init_cache(cfg, 1, 16, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.forward(params, [[1, 2]], cache, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(params, cfg, max_slots=1, max_seq=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_paged_cache(cfg, 1, 16, n_pages=3, page=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(params, cfg, max_slots=1, max_seq=16, paged=True,
               prefix_cache=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(REPO / "no-such-checkpoint")
    # the sparse-MoE model: params, forward and engine
    moe = PRESETS["test-tiny-moe"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_params(moe, seed=0)
    moe_params = llama.init_params(moe, seed=0, device="cpu")
    moe_cache = llama.init_cache(moe, 1, 16, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.forward(moe_params, [[1, 2]], moe_cache, moe)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(moe_params, moe, max_slots=1, max_seq=16, paged=True)
    # the DeepSeek (MLA) model: params, cache, forward and engine
    mla = PRESETS["test-tiny-dsv3"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_params(mla, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_cache(mla, 1, 16)
    mla_params = llama.init_params(mla, seed=0, device="cpu")
    mla_cache = llama.init_cache(mla, 1, 16, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.forward(mla_params, [[1, 2]], mla_cache, mla)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(mla_params, mla, max_slots=1, max_seq=16)
    # the serve entry point loads its checkpoint onto the card first
    from quant_tpu_torch.cli import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["serve", str(REPO / "no-such-checkpoint"), "--paged"])
    out = subprocess.run(
        [sys.executable, "-m", "quant_tpu_torch", "generate", "unused",
         "--prompt-ids", "1"], capture_output=True, text=True, timeout=120,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_convert_eval_selftest_default_to_the_card(tmp_path):
    """``convert``, ``eval`` and ``selftest`` (functions and CLI) take the
    card unless asked for the CPU: without a GPU they raise."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the card default is usable")
    from quant_tpu_torch.checkpoint.hf import convert_hf_llama
    from quant_tpu_torch.cli import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert_hf_llama(tmp_path / "hf", tmp_path / "out")
    for argv in (["convert", str(tmp_path / "hf"), str(tmp_path / "out")],
                 ["eval", str(REPO / "no-such-checkpoint"), "--text",
                  str(REPO / "README.md")],
                 ["selftest"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
