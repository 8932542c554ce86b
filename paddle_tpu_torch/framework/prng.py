"""The JAX key stream in PyTorch: ``PRNGKey``, ``fold_in``, ``random_bits``,
``uniform``, ``gumbel`` and ``categorical`` as JAX 0.9 computes them with
its defaults (threefry2x32, ``jax_threefry_partitionable`` on, 32-bit
mode, the "low" Gumbel mode).

A seeded serving request draws its tokens from
``categorical(fold_in(PRNGKey(seed), n_generated), logits)`` in the JAX
engine; this module gives the port the same bits, so the same seeded
request decodes the same tokens in both packages.

The process's key stream (`seed`, `next_rng_key`) is JAX's
``core.state``: key n is ``fold_in(PRNGKey(seed), n)``, n counting the
draws since the seed.  The MoE gates draw their random routing from it.

Keys are int64 tensors ``[..., 2]`` holding uint32 words; the arithmetic
is int64 masked to 32 bits (sums below 2^34, shifts of 32-bit words by at
most 29 places), so it runs on the CPU and on the card alike, with no host
read, and can be captured in a CUDA graph.  Leading dimensions of a key
batch over rows: ``random_bits(keys[ns, 2], (V,))`` is ``[ns, V]``, each
row the bits of its own key (JAX's ``vmap`` over keys).
"""
from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pair ``(x1,
    x2)`` under the key ``(k1, k2)``: int64 tensors of uint32 words that
    broadcast together.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def PRNGKey(seed):
    """``jax.random.PRNGKey(seed)``: ``[0, seed mod 2^32]`` in JAX's
    default 32-bit mode.  An int64 tensor ``[2]`` on the CPU."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: the hash of the counter pair
    ``(0, data)``.  ``key`` [..., 2]; ``data`` an int or an integer tensor
    broadcasting against ``key[..., 0]``."""
    if not torch.is_tensor(data):
        data = torch.tensor(int(data), device=key.device)
    data = data.to(torch.int64) & MASK
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([o1, o2], dim=-1)


def _bits32(key, shape):
    """The partitionable threefry bits: counters are the flat index of
    each element as a 64-bit iota split in (high, low) words, and the
    value is the XOR of the two output words.  [..., *shape] int64."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    view = (*lead, *([1] * len(shape)))
    k1 = key[..., 0].reshape(view)
    k2 = key[..., 1].reshape(view)
    b1, b2 = threefry2x32(k1, k2, (idx >> 32).reshape(shape),
                          (idx & MASK).reshape(shape))
    return b1 ^ b2


def random_bits(key, shape, bit_width=32):
    """``jax.random.bits(key, shape, uint{bit_width})`` as int64 values:
    the low ``bit_width`` bits of the 32-bit draw (8, 16 or 32)."""
    if bit_width not in (8, 16, 32):
        raise ValueError(f"bit_width must be 8, 16 or 32, got {bit_width}")
    bits = _bits32(key, tuple(shape))
    return bits if bit_width == 32 else bits & ((1 << bit_width) - 1)


#: float dtype -> (bits drawn, mantissa bits, integer view, bits of 1.0)
_FLOAT_LAYOUT = {torch.float32: (32, 23, torch.int32, 0x3F800000),
                 torch.bfloat16: (8, 7, torch.int16, 0x3F80),
                 torch.float16: (16, 10, torch.int16, 0x3C00)}


def uniform(key, shape, dtype=torch.float32, minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``: the
    drawn bits fill the mantissa of a float in [1, 2) (JAX draws 8 bits
    for a type with fewer than 8 mantissa bits), minus one, scaled to
    [minval, maxval) in ``dtype``."""
    nbits, nmant, view, one = _FLOAT_LAYOUT[dtype]
    bits = random_bits(key, shape, nbits)
    float_bits = (bits >> (nbits - nmant)) | one
    floats = float_bits.to(view).view(dtype) - 1.0
    lo = torch.full((), minval, dtype=dtype, device=key.device)
    hi = torch.full((), maxval, dtype=dtype, device=key.device)
    # XLA fuses the scale and shift into one FMA (one rounding): the
    # product of two floats is exact in double, so one rounding after
    scaled = floats.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, scaled.to(dtype))


def gumbel(key, shape, dtype=torch.float32):
    """``jax.random.gumbel`` in its default "low" mode:
    ``-log(-log(uniform(minval=tiny)))`` in ``dtype``."""
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(uniform(key, shape, dtype, minval=tiny)))


def categorical(key, logits):
    """``jax.random.categorical(key, logits)`` over the last axis: the
    argmax of ``gumbel + logits``, the Gumbel noise in the logits' dtype.
    ``key`` [..., 2] batches over the leading axes of ``logits``."""
    noise = gumbel(key, logits.shape[-1:], logits.dtype)
    return torch.argmax(noise + logits, dim=-1)


#: the process's key stream: JAX ``core.state``'s seed and counter
_STREAM = {"seed": 0, "counter": 0}


def seed(s):
    """Restart the key stream at ``s`` (JAX's ``paddle.seed``)."""
    _STREAM["seed"], _STREAM["counter"] = int(s), 0
    return s


def get_rng_state():
    """``(seed, counter)`` of the key stream."""
    return _STREAM["seed"], _STREAM["counter"]


def set_rng_state(state):
    """Put the key stream at ``(seed, counter)`` (e.g. JAX's
    ``STATE.rng_key`` seed and ``STATE.rng_counter``)."""
    _STREAM["seed"], _STREAM["counter"] = int(state[0]), int(state[1])


def _draw_counter():
    n = _STREAM["counter"]
    _STREAM["counter"] = n + 1
    return n


def next_rng_key(device="cpu"):
    """The stream's next key, ``fold_in(PRNGKey(seed), counter)`` (JAX's
    ``next_rng_key``), on ``device``.  On the card the counter is a
    device scalar (`kernels.graph_state.device_seed`), so a captured
    step refills it before each replay and each replay draws a fresh
    key.  A recomputed region (activation recompute) takes its first
    run's counter back instead of drawing one, as JAX's checkpoint
    reuses the traced key."""
    from ..kernels import graph_state
    device = torch.device(device)
    n = graph_state.logged_draw(
        lambda: graph_state.device_seed(_draw_counter, device))
    return fold_in(PRNGKey(_STREAM["seed"]).to(device), n)
