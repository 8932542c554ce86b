"""Package rules of the port: it never imports JAX or the JAX package,
its entry points refuse to fall back to the CPU on their own, and its
kernel build is keyed by the sources' content."""
import ast
from pathlib import Path

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import device as D
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.models import LlamaForCausalLM, llama_config

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _port_files():
    pkg = Path(paddle_tpu_torch.__file__).parent
    return sorted(pkg.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "id", None) == "__import__" and \
                node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaForCausalLM(llama_config("tiny"))
    assert D.resolve_device("cpu") == torch.device("cpu")


def test_dtype_names():
    assert D.to_torch_dtype("bfloat16") is torch.bfloat16
    assert D.to_torch_dtype(torch.float16) is torch.float16
    with pytest.raises(ValueError, match="unsupported dtype"):
        D.to_torch_dtype("int8")


def test_build_sources_and_hash(tmp_path, monkeypatch):
    names = {p.name for p in _build.sources()}
    assert {"rms_norm.cu", "paged_decode.cu"} <= names
    h = _build.source_hash()
    assert h == _build.source_hash() and len(h) == 16
    (tmp_path / "a.cu").write_text("// a\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    h1 = _build.source_hash()
    (tmp_path / "a.cu").write_text("// b\n")
    assert _build.source_hash() != h1 != h


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
