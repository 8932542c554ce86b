"""LoRA training in the port (paddle_tpu_torch/nn/lora.py) against the JAX
package's (paddle_tpu/nn/lora.py) on the CPU.

- The counterparts of tests/test_lora.py's training-lane cases: wrapping
  and the gradient mask (only the factors move; the base stays bit for
  bit), merge / unmerge bit for bit, the adapter round trip and the rank
  check, the construction errors, and the frozen-base compiled step
  against the eager lane (here bit for bit: both lanes run the same
  torch ops on the CPU).
- ``save_adapter`` in either package read by the other's
  ``load_adapter``, the factors exactly; ``convert`` carrying a wrapped
  JAX model's parameters, ``lora_A`` / ``lora_B`` included, exactly.
- ``Model.fit`` of a LoRA-wrapped tiny GPT and Llama (fp32, width 64, 2
  layers, the same weights through ``convert``) against JAX ``fit``, in
  both lanes: losses to ``LOSS_RTOL`` relative, the factors to
  ``PARAM_ATOL`` + ``PARAM_RTOL`` relative, the frozen base exactly
  equal to its start (tests/test_torch_hapi.py's tolerances: XLA:CPU
  contracts multiply-adds, torch rounds each op).
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.hapi import Model as JModel
from paddle_tpu.io import TensorDataset as JTensorDataset
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_llama_config
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu_torch import convert, nn
from paddle_tpu_torch.framework.checkpoint_manager import (read_manifest,
                                                           verify_checkpoint)
from paddle_tpu_torch.hapi import Callback, Model
from paddle_tpu_torch.io import TensorDataset
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     gpt_config, llama_config)
from paddle_tpu_torch.nn import CrossEntropyLoss, Linear, LoRALinear
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.utils import flags as port_flags

SEQ = 32
LR = 1e-3
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
PARAM_RTOL = 1e-2
GPT_TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                max_seq_len=SEQ)
LLAMA_TINY = dict(hidden_size=64, num_heads=4, num_kv_heads=2,
                  intermediate_size=192, max_seq_len=SEQ)


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = port_flags.get_flags(["FLAGS_compiled_train_step"])
    jsaved = paddle.get_flags("FLAGS_compiled_train_step")
    yield
    port_flags.set_flags(saved)
    paddle.set_flags(jsaved)


class _MLP(torch.nn.Module):
    def __init__(self, seed=0):
        super().__init__()
        self.fc_in = Linear(8, 16, device="cpu")
        self.fc_out = Linear(16, 4, device="cpu")
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            self.fc_in.reset_parameters(gen)
            self.fc_out.reset_parameters(gen)

    def forward(self, x):
        return self.fc_out(torch.relu(self.fc_in(x)))


def _batches(steps=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.standard_normal((4, 8)).astype("float32")),
             torch.from_numpy(rng.standard_normal((4, 4)).astype("float32")))
            for _ in range(steps)]


def _mse(o, y):
    return ((o - y) ** 2).mean()


# ------------------------------------------------ tests/test_lora.py cases


def test_attach_and_grad_mask():
    """attach_lora wraps the named projections; after
    mark_only_lora_trainable a training run moves only the factors, the
    base weight and bias stay bit for bit."""
    net = _MLP()
    assert nn.attach_lora(net, rank=4) == ["fc_in", "fc_out"]
    assert isinstance(net.fc_in, LoRALinear)
    assert nn.mark_only_lora_trainable(net) == 4
    trainable = sorted(n for n, p in net.named_parameters()
                       if p.requires_grad)
    assert trainable == ["fc_in.lora_A", "fc_in.lora_B",
                         "fc_out.lora_A", "fc_out.lora_B"]
    frozen = {n: p.detach().clone() for n, p in net.named_parameters()
              if not p.requires_grad}
    before = {n: p.detach().clone() for n, p in net.named_parameters()
              if p.requires_grad}
    opt = AdamW(0.05, parameters=[p for p in net.parameters()
                                  if p.requires_grad])
    for x, y in _batches():
        _mse(net(x), y).backward()
        opt.step()
        opt.clear_grad()
    for n, p in net.named_parameters():
        if p.requires_grad:
            assert not torch.equal(p, before[n]), f"{n} never trained"
        else:
            assert torch.equal(p, frozen[n]), n


def test_merge_unmerge_bitwise():
    """merge() writes W + A@B*scale into the weight with the unmerged
    forward's expression: outputs equal bit for bit; unmerge() restores
    the exact weight, in place."""
    net = _MLP()
    nn.attach_lora(net, rank=4, alpha=8)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for lyr in nn.lora_layers(net).values():
            lyr.lora_B.copy_(torch.from_numpy(rng.standard_normal(
                tuple(lyr.lora_B.shape)).astype(np.float32) * 0.1))
    x = torch.from_numpy(rng.standard_normal((3, 8)).astype("float32"))
    with torch.no_grad():
        y0 = net(x)
    w0 = net.fc_in.weight.detach().clone()
    ptr = net.fc_in.weight.data_ptr()
    for lyr in nn.lora_layers(net).values():
        lyr.merge()
        assert lyr.merged
    with torch.no_grad():
        assert torch.equal(net(x), y0)
    assert not torch.equal(net.fc_in.weight, w0)
    for lyr in nn.lora_layers(net).values():
        lyr.unmerge()
    assert torch.equal(net.fc_in.weight, w0)
    assert net.fc_in.weight.data_ptr() == ptr
    with torch.no_grad():
        assert torch.equal(net(x), y0)


def test_save_load_adapter_roundtrip(tmp_path):
    """save_adapter writes only the factors (crc-manifested); load_adapter
    restores them exactly into a freshly wrapped model; a rank mismatch
    raises."""
    net = _MLP()
    nn.attach_lora(net, rank=4, alpha=16)
    rng = np.random.default_rng(2)
    with torch.no_grad():
        for lyr in nn.lora_layers(net).values():
            for p in (lyr.lora_A, lyr.lora_B):
                p.copy_(torch.from_numpy(rng.standard_normal(
                    tuple(p.shape)).astype(np.float32)))
    d = str(tmp_path / "adapter")
    os.makedirs(d)
    nn.save_adapter(net, d)
    assert verify_checkpoint(d)
    meta = read_manifest(d)["meta"]
    assert meta["format"] == "lora_adapter"
    assert meta["layers"]["fc_in"]["rank"] == 4
    other = _MLP(seed=7)
    nn.attach_lora(other, rank=4)
    nn.load_adapter(other, d)
    for name, lyr in nn.lora_layers(net).items():
        l2 = nn.lora_layers(other)[name]
        assert torch.equal(lyr.lora_A, l2.lora_A)
        assert torch.equal(lyr.lora_B, l2.lora_B)
        assert l2.alpha == 16 and l2.scaling == lyr.scaling
    third = _MLP()
    nn.attach_lora(third, rank=2)
    with pytest.raises(ValueError, match="rank"):
        nn.load_adapter(third, d)


def test_lora_construction_errors():
    with pytest.raises(TypeError, match="Linear"):
        LoRALinear(nn.LayerNorm(8, device="cpu"))
    with pytest.raises(ValueError, match="rank"):
        LoRALinear(Linear(4, 4, device="cpu"), rank=0)
    with pytest.raises(ValueError, match="no Linear sublayers"):
        nn.attach_lora(_MLP(), targets=("does_not_exist",))
    with pytest.raises(ValueError, match="no LoRA"):
        nn.mark_only_lora_trainable(_MLP())
    with pytest.raises(ValueError, match="no LoRA"):
        nn.adapter_spec(_MLP())


def _fit_lora(compiled, steps=6):
    port_flags.set_flags({"FLAGS_compiled_train_step": compiled})
    net = _MLP()
    nn.attach_lora(net, rank=4)
    nn.mark_only_lora_trainable(net)
    opt = AdamW(0.05, parameters=[p for p in net.parameters()
                                  if p.requires_grad])
    model = Model(net)
    model.prepare(optimizer=opt, loss=_mse)
    losses = [model.train_batch(x, y)[0] for x, y in _batches(steps)]
    base = {n: p.detach().clone() for n, p in net.named_parameters()
            if not p.requires_grad}
    lora = {n: p.detach().clone() for n, p in net.named_parameters()
            if p.requires_grad}
    return losses, base, lora, model


def test_compiled_train_step_frozen_base_matches_eager():
    """A LoRA-wrapped model rides the compiled train step unchanged: the
    losses and the factors equal the eager lane's bit for bit (the same
    torch ops on the CPU), the frozen base never moves."""
    le, base_e, lora_e, _ = _fit_lora(False)
    lc, base_c, lora_c, mc = _fit_lora(True)
    cs = mc._compiled_step
    assert cs and cs.compiled, cs and cs.fallback_reason
    assert le == lc
    ref = dict(_MLP().named_parameters())
    for n in base_e:
        assert torch.equal(base_e[n], base_c[n]), n
        assert torch.equal(base_e[n], ref[n]), n
    for n in lora_e:
        assert torch.equal(lora_e[n], lora_c[n]), n


# ------------------------------------------------ across the two packages


def _jax_mlp(seed=0):
    paddle.seed(seed)
    return jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_adapter_files_cross_packages(tmp_path, writer):
    """An adapter written by either package's save_adapter loads into the
    other's wrapped model with the same factors, rank and alpha."""
    rng = np.random.default_rng(3)
    d = str(tmp_path / "adapter")
    os.makedirs(d)
    jnet = _jax_mlp()
    jnn.attach_lora(jnet, rank=4, alpha=8, targets=("0", "2"))
    tnet = torch.nn.Sequential(Linear(8, 16, device="cpu"), torch.nn.ReLU(),
                               Linear(16, 4, device="cpu"))
    nn.attach_lora(tnet, rank=4, alpha=8, targets=("0", "2"))
    want = {}
    for name in ("0", "2"):
        for f in ("lora_A", "lora_B"):
            shape = (8 if name == "0" else 16, 4) if f == "lora_A" else \
                (4, 16 if name == "0" else 4)
            want[f"{name}.{f}"] = rng.standard_normal(shape).astype(
                np.float32)
    if writer == "jax":
        for k, v in want.items():
            name, f = k.split(".")
            getattr(jnn.lora_layers(jnet)[name], f).set_value(v)
        jnn.save_adapter(jnet, d)
        nn.load_adapter(tnet, d)
        got = {f"{n}.{f}": getattr(lyr, f).detach().numpy()
               for n, lyr in nn.lora_layers(tnet).items()
               for f in ("lora_A", "lora_B")}
    else:
        with torch.no_grad():
            for k, v in want.items():
                name, f = k.split(".")
                getattr(nn.lora_layers(tnet)[name], f).copy_(
                    torch.from_numpy(v))
        nn.save_adapter(tnet, d, meta={"note": "port"})
        jnn.load_adapter(jnet, d)
        got = {f"{n}.{f}": np.asarray(getattr(lyr, f).numpy())
               for n, lyr in jnn.lora_layers(jnet).items()
               for f in ("lora_A", "lora_B")}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert nn.load_adapter_state(d)["0"]["alpha"] == 8.0


def _models(kind):
    paddle.seed(0)
    if kind == "llama":
        jm = JaxLlama(jax_llama_config("tiny", **LLAMA_TINY))
        tm = LlamaForCausalLM(llama_config("tiny", **LLAMA_TINY),
                              device="cpu")
    else:
        jm = JaxGPT(jax_gpt_config("gpt2-124m", **GPT_TINY))
        tm = GPTForCausalLM(gpt_config("gpt2-124m", **GPT_TINY),
                            device="cpu")
    jnames = jnn.attach_lora(jm, rank=4, alpha=8)
    tnames = nn.attach_lora(tm, rank=4, alpha=8)
    assert jnames == tnames
    # B away from zero, so the adapter changes the forward from step one
    rng = np.random.default_rng(5)
    for lyr in jnn.lora_layers(jm).values():
        lyr.lora_B.set_value(rng.standard_normal(
            tuple(lyr.lora_B.shape)).astype(np.float32) * 0.02)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    convert.load_paddle_tpu_state(tm, state)
    return jm, tm, state


@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_convert_carries_lora_factors(kind):
    """convert takes a wrapped JAX model's parameters across by name,
    lora_A and lora_B included, exactly; the two forwards agree."""
    jm, tm, state = _models(kind)
    assert any(k.endswith("lora_A") for k in state)
    own = tm.state_dict()
    assert sorted(own) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(own[k].numpy(), v, err_msg=k)
    ids = np.random.default_rng(0).integers(0, 512, (2, SEQ))
    jm.eval()
    tm.eval()
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


class _Losses(Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


@pytest.mark.parametrize("compiled", [False, True])
@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_fit_lora_matches_jax(kind, compiled):
    """fit of a LoRA-wrapped model with a frozen base: the port's losses
    and factors are JAX fit's, the base stays exactly where it started."""
    jm, tm, state = _models(kind)
    jnn.mark_only_lora_trainable(jm)
    nn.mark_only_lora_trainable(tm)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (8, SEQ + 1))
    x, y = ids[:, :-1].copy(), ids[:, 1:].copy()

    paddle.set_flags({"FLAGS_compiled_train_step": compiled})
    from paddle_tpu.hapi.callbacks import Callback as JCallback

    class JLosses(JCallback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
    jrec = JLosses()
    JModel(jm).prepare(
        paddle.optimizer.AdamW(LR, parameters=[
            p for p in jm.parameters() if p.trainable]),
        jnn.CrossEntropyLoss()).fit(
            JTensorDataset([x, y]), batch_size=2, epochs=2, verbose=0,
            shuffle=False, log_freq=1, callbacks=[jrec])

    port_flags.set_flags({"FLAGS_compiled_train_step": compiled})
    rec = _Losses()
    model = Model(tm).prepare(
        AdamW(LR, parameters=[p for p in tm.parameters() if p.requires_grad]),
        CrossEntropyLoss())
    model.fit(TensorDataset([x, y]), batch_size=2, epochs=2, verbose=0,
              shuffle=False, log_freq=1, callbacks=[rec])
    if compiled:
        assert model._compiled_step.compiled
    np.testing.assert_allclose(rec.losses, jrec.losses, rtol=LOSS_RTOL)
    jstate = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    for k, v in tm.state_dict().items():
        if k.rsplit(".", 1)[-1] in ("lora_A", "lora_B"):
            assert not np.array_equal(jstate[k], state[k]), k
            np.testing.assert_allclose(v.numpy(), jstate[k], rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)
