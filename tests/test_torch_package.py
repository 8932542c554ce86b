"""Package rules of the port: it never imports JAX or the JAX package,
its entry points refuse to fall back to the CPU on their own, and its
kernel build is keyed by the sources' content."""
import ast
import importlib
from pathlib import Path

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import device as D
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.models import LlamaForCausalLM, llama_config
from paddle_tpu_torch.serving.paged_kv import PagedKVCache

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


def test_paged_kv_cache_default_device_is_the_card(monkeypatch):
    """`PagedKVCache` with no device resolves to the card like every other
    entry point: without CUDA it raises; ``"cpu"`` is taken."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedKVCache(1, 1, 16, 1, 8)
    assert PagedKVCache(1, 1, 16, 1, 8, device="cpu").device == \
        torch.device("cpu")


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


def test_runtime_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """A ``Model`` of a default-device network, a ``device_prefetch`` and
    a ``CheckpointManager`` restore with no device given raise without
    CUDA instead of running on the CPU."""
    import numpy as np
    from paddle_tpu_torch import data as Dt
    from paddle_tpu_torch import load, save
    from paddle_tpu_torch.framework.checkpoint_manager import \
        CheckpointManager
    from paddle_tpu_torch.hapi import Model
    CheckpointManager(str(tmp_path), map_location="cpu").save(
        {"w": torch.ones(2)}, step=0)
    save({"w": torch.ones(2)}, str(tmp_path / "s.pkl"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(LlamaForCausalLM(llama_config("tiny")))
    pipe = Dt.pipeline(np.arange(8)).batch(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipe.device_prefetch(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CheckpointManager(str(tmp_path)).restore_latest()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load(str(tmp_path / "s.pkl"))
    assert CheckpointManager(str(tmp_path), map_location="cpu") \
        .restore_latest()[1] == 0


def _jax_init_exports():
    """(port package, name) for every name a paddle_tpu package's
    ``__init__`` imports from one of its own modules (``from .m import
    X``, ``from . import m``) whose port counterpart exists and defines it:
    read from the JAX package's source, so no JAX is imported."""
    jax_root = ROOT / "paddle_tpu"
    port_root = Path(paddle_tpu_torch.__file__).parent
    out = []
    for init in sorted(jax_root.rglob("__init__.py")):
        rel = init.parent.relative_to(jax_root)
        if not (port_root / rel / "__init__.py").exists():
            continue
        pkg = ".".join(("paddle_tpu_torch",) + rel.parts)
        for node in ast.parse(init.read_text()).body:
            if not isinstance(node, ast.ImportFrom) or node.level != 1:
                continue
            for alias in node.names:
                name = alias.asname or alias.name
                if name.startswith("_") or alias.name == "*":
                    continue
                mod = node.module or alias.name
                path = port_root.joinpath(*rel.parts, *mod.split("."))
                if not (path.with_suffix(".py").exists()
                        or (path / "__init__.py").exists()):
                    continue
                if node.module is not None and not hasattr(
                        importlib.import_module(f"{pkg}.{node.module}"),
                        alias.name):
                    continue        # not ported yet (ROADMAP queues)
                out.append((pkg, name))
    return out


def test_packages_export_what_jax_exports():
    """Each ported package exports what its JAX ``__init__`` exports from
    a module the port has (ROADMAP Queue C 4: ``framework``'s checkpoint
    and sentinel names, ``models``' ``GPTModel`` / ``LlamaModel`` and the
    presets, ``utils``' ``set_flags`` / ``get_flags``, ``serving``'s
    stats, ...)."""
    pairs = _jax_init_exports()
    assert ("paddle_tpu_torch.framework", "CheckpointManager") in pairs
    missing = [f"{pkg}.{name}" for pkg, name in pairs
               if not hasattr(importlib.import_module(pkg), name)]
    assert not missing, missing


def test_log_level_and_log_every_n():
    """`utils.log.set_log_level` and `log_every_n`, as JAX's: the 1st,
    4th and 7th of 7 calls of one site are emitted at n = 3."""
    import logging
    from paddle_tpu_torch.utils import log
    logger = log.get_logger()
    old = logger.level
    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())
    handler = Keep()
    logger.addHandler(handler)
    try:
        log.set_log_level("warning")
        assert logger.level == logging.WARNING
        log.set_log_level(logging.INFO)
        for i in range(7):
            log.log_every_n("info", "every-n site %d", 3, i)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old)
    assert seen == ["every-n site 0", "every-n site 3", "every-n site 6"]


#: each deliberate difference of a shared callable's parameters from JAX's
#: (ROADMAP Queue C records each one)
SIGNATURE_ALLOW = {
    # JAX places a batch by a sharding; a torch process by a device
    "data.prefetch.to_device_batch",
    # a torch store wrapped where JAX wraps its coordination client
    "distributed.host_collectives.CoordKVStore.__init__",
    # NCCL returns at the enqueue: the entry ends with the op's CUDA event
    "distributed.watchdog.CollectiveWatchdog.end",
    "distributed.watchdog.end",
    # JAX's hand-off from a jitted program; the port's tick advances the
    # device offsets in place and the host mirror follows
    "serving.paged_kv.PagedKVCache.absorb_tick",
}


def _sig_fault(jax_fn, port_fn):
    """Why ``port_fn``'s parameters do not begin with ``jax_fn``'s, in
    JAX's order, with its extras keyword-only; None when they do."""
    import inspect
    kinds = (inspect.Parameter.POSITIONAL_ONLY,
             inspect.Parameter.POSITIONAL_OR_KEYWORD)
    try:
        jp = list(inspect.signature(jax_fn).parameters.values())
        pp = list(inspect.signature(port_fn).parameters.values())
    except (TypeError, ValueError):
        return None
    jp = [p for p in jp if p.name not in ("self", "cls")]
    pp = [p for p in pp if p.name not in ("self", "cls")]
    jpos = [p.name for p in jp if p.kind in kinds]
    ppos = [p.name for p in pp if p.kind in kinds]
    if ppos != jpos:
        return f"positional {ppos} != JAX's {jpos}"
    star = inspect.Parameter.VAR_POSITIONAL
    if any(p.kind == star for p in jp) != any(p.kind == star for p in pp):
        return "*args differ"
    kw_only = inspect.Parameter.KEYWORD_ONLY
    missing = {p.name for p in jp if p.kind == kw_only} - \
        {p.name for p in pp if p.kind == kw_only}
    if missing and not any(p.kind == inspect.Parameter.VAR_KEYWORD
                           for p in pp):
        return f"keyword-only {sorted(missing)} missing"
    return None


def _shared_callables():
    """(name, JAX callable, port callable) of every public function and
    class (its ``__init__`` and public methods) that the port defines and
    the JAX module or package of the same path has under the same name
    (a package pairs what both ``__init__`` files export).  Named by the
    port module that defines it."""
    import inspect
    import pkgutil
    seen = set()
    mods = [("", paddle_tpu_torch)]
    for info in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                      "paddle_tpu_torch."):
        if not info.name.endswith("__main__"):
            mods.append((info.name[len("paddle_tpu_torch."):],
                         importlib.import_module(info.name)))
    for rel, port in mods:
        try:
            ref = importlib.import_module(
                "paddle_tpu" + ("." + rel if rel else ""))
        except ImportError:
            continue                    # no JAX module of that path
        for attr in dir(port):
            obj, jobj = getattr(port, attr), getattr(ref, attr, None)
            where = getattr(obj, "__module__", None) or ""
            if attr.startswith("_") or jobj is None or id(obj) in seen or \
                    not where.startswith("paddle_tpu_torch."):
                continue
            name = f"{where[len('paddle_tpu_torch.'):]}.{attr}"
            if inspect.isclass(obj) and inspect.isclass(jobj):
                seen.add(id(obj))
                yield f"{name}.__init__", jobj.__init__, obj.__init__
                for meth, fn in vars(obj).items():
                    jfn = inspect.getattr_static(jobj, meth, None)
                    if meth.startswith("_") or jfn is None or \
                            isinstance(fn, property) or \
                            isinstance(jfn, property) or \
                            not callable(getattr(obj, meth)) or \
                            not callable(getattr(jobj, meth)):
                        continue
                    yield (f"{name}.{meth}", getattr(jobj, meth),
                           getattr(obj, meth))
            elif inspect.isfunction(obj) and callable(jobj) and \
                    not inspect.isclass(jobj):
                seen.add(id(obj))
                yield name, jobj, obj


def test_shared_callables_bind_as_jax():
    """A call written for ``paddle_tpu`` binds on the port as it binds on
    JAX: for each public callable a port module shares with its JAX
    module, the port's parameters begin with JAX's, in JAX's order, and
    its extras are keyword-only (ROADMAP Queue C; `SIGNATURE_ALLOW` names
    each deliberate difference)."""
    found, faults = set(), []
    for name, jax_fn, port_fn in _shared_callables():
        found.add(name)
        fault = _sig_fault(jax_fn, port_fn)
        if fault is not None and name not in SIGNATURE_ALLOW:
            faults.append(f"{name}: {fault}")
    assert not faults, "\n".join(faults)
    assert SIGNATURE_ALLOW <= found, SIGNATURE_ALLOW - found
    for name in ("nn.functional.rms_norm", "nn.layers.LayerNorm.__init__",
                 "serving.adapters.lora_delta",
                 "distributed.env.init_parallel_env"):
        assert name in found
