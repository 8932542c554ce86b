"""The port's layers resolve ``device`` as every entry point does
(paddle_tpu_torch/device.py ``resolve_device``): ``None`` means the card,
and without CUDA a layer built with no device raises instead of putting
its parameters on the CPU; ``device="cpu"`` builds on the CPU."""
import pytest
import torch

from paddle_tpu_torch.nn import layers

LAYERS = {
    "Linear": lambda **kw: layers.Linear(4, 3, **kw),
    "Embedding": lambda **kw: layers.Embedding(10, 4, **kw),
    "RMSNorm": lambda **kw: layers.RMSNorm(4, **kw),
    "LayerNorm": lambda **kw: layers.LayerNorm(4, **kw),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_without_device_raises_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LAYERS[name]()


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_on_cpu_when_asked(name):
    layer = LAYERS[name](device="cpu")
    params = list(layer.parameters())
    assert params and all(p.device.type == "cpu" for p in params)
