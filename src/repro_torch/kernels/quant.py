"""Int8 (q8) KV quantization for the ``paged_q8`` cache kind, in plain
PyTorch.

Counterpart of ``repro.kernels.quant`` (the port imports nothing of the
JAX package).  Layout contract, as in the fp paged pool
(``serving.paged_kv_cache``):
  * pools are int8 pages (…, NB, bs, Hkv, Dh);
  * every (page, kv-head) pair owns ONE float32 scale: the scale arrays
    are (…, NB, Hkv) and travel with their page through copy-on-write and
    ring recycling;
  * dequant is ``ints * scale`` (symmetric, no zero point, so an unwritten
    page dequantizes to exactly 0).

Determinism contract: these are not kernels.  Every route (``impl``
"cuda" and "torch", on the card and on the CPU) quantizes through these
torch ops, so the pool BITS do not depend on the attention route; only
the dequantizing attention read differs.  On the same float32 input the
ints and scales equal the JAX package's bit for bit: the same operations
in the same order (float32 ``absmax / 127`` floored at ``Q8_EPS``, then
``x / scale``, round half to even, clip to ±127).  Whole-prompt prefill
quantizes each layer's K/V once (``q8_quantize_seq``), attends over those
bits and writes the same bits into the pool, so decode later reads back
exactly what the prompt's logits saw.

Decode appends use a MONOTONE per-page scale merge (``q8_append_token``):
while a page is live its scale only grows, so stored tokens are only
rescaled by a ratio <= 1.  A page's scale is reset when decode enters it
at offset 0 (fresh and recycled pages hold stale content and a stale
scale, both hidden by the causal mask).
"""
from __future__ import annotations

import torch

Q8_MAX = 127.0
# floor for every stored scale: keeps the divisions finite on all-zero
# blocks without changing their (all-zero) quantized content
Q8_EPS = 1e-8


def _absmax_scale(x: torch.Tensor, dim) -> torch.Tensor:
    """max |x| over ``dim`` / 127, floored at ``Q8_EPS``.  The divisor is
    a tensor on x's device, not a Python number: on a CUDA tensor PyTorch
    turns division by a Python scalar into a multiplication by its
    reciprocal, which rounds differently from the division the CPU (and
    the JAX package) performs."""
    amax = x.abs().amax(dim=dim)
    return torch.clamp_min(amax / amax.new_full((), Q8_MAX), Q8_EPS)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale) clipped to ±127, as float32 (round half to even,
    like ``jnp.round``)."""
    return torch.clamp(torch.round(x / scale), -Q8_MAX, Q8_MAX)


def q8_quantize_pages(blocks: torch.Tensor):
    """Quantize block-shaped KV: (..., nbk, bs, Hkv, D) float ->
    ((..., nbk, bs, Hkv, D) int8, (..., nbk, Hkv) float32 scales).

    One scale per (block, kv head) = absmax / 127 over the block's (bs, D)
    entries: exactly the pool's scale granularity."""
    x = blocks.float()
    scale = _absmax_scale(x, (-3, -1))  # (..., nbk, Hkv)
    ints = _quantize(x, scale[..., :, None, :, None]).to(torch.int8)
    return ints, scale


def q8_quantize_seq(kv: torch.Tensor, block_size: int, valid=None):
    """Quantize a sequence-major KV tensor at pool granularity.

    kv (B, S, Hkv, D) float with S % block_size == 0; ``valid`` (B, S)
    bool zeroes bucket padding (positions >= true_len) BEFORE the
    per-block absmax, so padding never inflates a real block's scale.
    Returns ((B, S, Hkv, D) int8, (B, S // block_size, Hkv) float32)."""
    B, S, Hkv, D = kv.shape
    x = kv.float()
    if valid is not None:
        x = torch.where(valid[..., None, None], x, 0.0)
    ints, scale = q8_quantize_pages(x.reshape(B, S // block_size, block_size,
                                              Hkv, D))
    return ints.reshape(B, S, Hkv, D), scale


def q8_dequant_seq(ints: torch.Tensor, scale: torch.Tensor,
                   out_dtype) -> torch.Tensor:
    """Inverse of ``q8_quantize_seq``: (B, S, Hkv, D) int8 + (B, nbk, Hkv)
    scales -> (B, S, Hkv, D) ``out_dtype`` (dequantized in float32)."""
    bs = ints.shape[1] // scale.shape[1]
    s = torch.repeat_interleave(scale, bs, dim=1)  # (B, S, Hkv)
    return (ints.float() * s[..., None]).to(out_dtype)


def q8_append_token(pool: torch.Tensor, scale: torch.Tensor,
                    new_tok: torch.Tensor, page: torch.Tensor,
                    off: torch.Tensor, live=None) -> None:
    """Quantize-on-write of one decode token per write, in place.

    pool (NB, bs, Hkv, D) int8, scale (NB, Hkv) float32, new_tok
    (n, Hkv, D) float, page (n,) physical pages and off (n,) in-page
    offsets.  Two writes may share a page and offset only if they carry
    the same token (``models.transformer.paged_append_slots`` aims idle
    batch rows so: torch has no ``mode="drop"`` scatter); they then write
    the same bits.  ``live`` (a () bool tensor, default true): false
    writes back what the pages hold, so a step with no mapped row changes
    nothing without a host sync.  Monotone scale merge: at off == 0 the
    page is being (re-)entered (fresh page, ring recycle or detach), so
    its stale scale is ignored and reset from this token; at off > 0 the
    scale only grows (new = max(old, token's)) and the page's stored ints
    are rescaled by old / new <= 1 (a no-op round when the scale does not
    grow).

    Where a mesh's model axis splits the pool, the caller passes the
    rank's own pages and their scale rows (the local tensors) and page ids
    as local indices; a write whose page lies on another rank is aimed
    like an idle row's (``paged_append_slots``), so the ints and the
    scale row of a page change together, on the rank that holds it."""
    newf = new_tok.float()
    tok_scale = _absmax_scale(newf, -1)
    fresh = (off == 0)[:, None]  # (n, 1): first write of this page
    old_scale, old_ints = scale[page], pool[page]
    base = torch.where(fresh, Q8_EPS, old_scale)
    new_scale = torch.maximum(base, tok_scale)  # (n, Hkv)
    ratio = torch.where(fresh, 1.0, base / new_scale)
    ints = torch.clamp(torch.round(old_ints.float() *
                                   ratio[:, None, :, None]), -Q8_MAX, Q8_MAX)
    ints[torch.arange(len(page), device=page.device), off] = \
        _quantize(newf, new_scale[..., None])
    ints = ints.to(torch.int8)
    if live is not None:
        ints = torch.where(live, ints, old_ints)
        new_scale = torch.where(live, new_scale, old_scale)
    pool[page] = ints
    scale[page] = new_scale
