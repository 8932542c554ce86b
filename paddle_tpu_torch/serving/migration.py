"""Live KV-page migration: the wire format between serving replicas (port
of paddle_tpu/serving/migration.py).

Prefill/decode disaggregation moves a request's hot KV pages from the
replica that computed its prompt to the replica that will decode it.  A
migration is exactly

- one pickled **header** (small): pool geometry, offset, page count, the
  store dtype's name and the quantization;
- one pickled **meta** dict (small, built by the fleet): the request
  itself (prompt ids, tokens emitted so far, sampling, budgets, the
  remaining deadline, the transfer span's trace context);
- 2 or 4 **raw byte frames** (large): the layer-pooled K and V pages
  (``[num_layers, n, page_size, H, D]``, the sender's pool rows bit for
  bit), plus the per-row scales ``[num_layers, n, page_size]`` float32
  when the pool stores int8 or fp8.

The frames ride `distributed.rpc.Blob`: ``send_bytes`` straight from the
exported tensors' bytes, never pickle's object graph.  They carry raw
bytes (numpy has no bfloat16 or float8), and the header keeps the JAX
package's dtype names, so both packages' frames are equal byte for byte
for the same pool contents and each `unpack` reads the other's payload.
`PagedKVCache.adopt_pages` installs the pages as slot-private pages.

Wire format version history:
  1: header/meta/K/V(+scales) as above.
"""
from __future__ import annotations

import warnings

import torch

from .paged_kv import dtype_name, dtype_of

WIRE_VERSION = 1


def _frame(t):
    """A ``Blob`` over a contiguous CPU tensor's bytes (no copy)."""
    from ..distributed.rpc import Blob
    return Blob(t.contiguous().view(torch.uint8).numpy())


def export_slot(cache, slot):
    """Snapshot ``slot``'s cached pages from ``cache`` (a `PagedKVCache`)
    into ``(header, blobs)`` for the rpc raw-bytes path."""
    return pack(cache, *cache.export_pages(slot))


def pack(cache, off, k, v, ks=None, vs=None):
    """``(header, blobs)`` of exported pages: ``k`` / ``v`` ``[num_layers,
    n, page_size, H, D]`` host tensors (the global heads: a tensor
    parallel replica gathers its ranks' heads first), the scales or
    None, ``off`` the cached-token count."""
    header = {
        "version": WIRE_VERSION,
        "page_size": cache.page_size,
        "offset": off,
        "num_pages": int(k.shape[1]),
        "num_layers": int(k.shape[0]),
        "kv_heads": int(k.shape[3]),
        "head_dim": int(k.shape[4]),
        "store_dtype": dtype_name(k.dtype),
        "quant": cache.quant_dtype,
    }
    blobs = [_frame(k), _frame(v)]
    if ks is not None:
        blobs += [_frame(ks), _frame(vs)]
    return header, blobs


def _tensor(blob, dtype, shape):
    with warnings.catch_warnings():
        # a received frame is read-only bytes; the tensor is only read
        warnings.filterwarnings("ignore", message=".*not writable")
        return torch.frombuffer(blob.data, dtype=torch.uint8) \
            .view(dtype).reshape(shape)


def unpack(header, *blobs):
    """Inverse of `export_slot` on the receiving replica: the page tensors
    (CPU, over the received frames) in the dict `Engine.submit_resume`
    takes.  Raises `PageMigrationError` on a version, frame-count or size
    mismatch: a malformed payload fails before it touches a pool."""
    from .api import PageMigrationError
    if header.get("version") != WIRE_VERSION:
        raise PageMigrationError(
            f"migration wire version {header.get('version')!r} != "
            f"supported {WIRE_VERSION}")
    quant = header.get("quant") is not None
    want = 4 if quant else 2
    if len(blobs) != want:
        raise PageMigrationError(
            f"{len(blobs)} page frames for a "
            f"{'quantized' if quant else 'float'} pool (expected {want})")
    shape = (header["num_layers"], header["num_pages"],
             header["page_size"], header["kv_heads"], header["head_dim"])
    try:
        dt = dtype_of(header["store_dtype"])
    except ValueError as e:
        raise PageMigrationError(str(e)) from None
    expect = 1
    for d in shape:
        expect *= int(d)
    expect *= dt.itemsize
    for b in blobs[:2]:
        if len(b) != expect:
            raise PageMigrationError(
                f"page frame holds {len(b)} bytes, geometry says "
                f"{expect}")
    out = {"offset": int(header["offset"]),
           "k_pages": _tensor(blobs[0], dt, shape),
           "v_pages": _tensor(blobs[1], dt, shape),
           "k_scales": None, "v_scales": None}
    if quant:
        sshape = shape[:3]
        out["k_scales"] = _tensor(blobs[2], torch.float32, sshape)
        out["v_scales"] = _tensor(blobs[3], torch.float32, sshape)
    return out
