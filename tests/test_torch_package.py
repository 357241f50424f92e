"""cosmos_tpu_torch stands alone: no module of it (nor chip_smoke.py and
the directory writer it imports, tests/torch_tokenizer_dirs.py) imports
jax, flax, cosmos_tpu, or regex, transformers, tokenizers and
sentencepiece (absent on the card's machine), and
its entry points do not fall back to
the CPU when CUDA is missing."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import cosmos_tpu_torch
from cosmos_tpu_torch import create_model

PKG = Path(cosmos_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "flax", "cosmos_tpu", "regex", "transformers",
             "tokenizers", "sentencepiece")


def _top_level_imports(path: Path):
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module.split(".")[0])
    return names


SOURCES = sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_tokenizer_dirs.py"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports_in_source(path):
    bad = [n for n in _top_level_imports(path) if n in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_importing_every_module_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PKG.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_create_model_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model("ViT-Tiny-Test")


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
