"""Causal / sliding-window / non-causal GQA flash attention: wrappers of
``csrc/flash_attention.cu`` (head dims 64, 80 and 128).

Counterparts of ``repro.kernels.flash_attention``'s three kernels:

  * ``flash_attention_bhsd`` — generic: head-major q (B, Hq, Sq, D) and
    k/v (B, Hkv, Sk, D); ``flash_attention_bshd`` launches the same
    kernel on sequence-major (B, S, H, D) views with their own strides;
  * ``flash_attention_merged_bsd`` — the paper's merged (Q/P-removed)
    prefill fast path: the RoPE'd residual stream viewed (B, Sq, Hq, D) is
    the query, K*/V* tiles are read in their native (B, Sk, Hkv, D) layout
    and the output lands as (B, Sq, Hq, D), a view of the FFN-input stream;
  * ``flash_attention_merged_q8_bsd`` — the merged prefill over int8
    K*/V* (B, Sk, Hkv, D) with float32 scales (B, Sk // sg, Hkv), one per
    page of ``sg`` rows and kv head (``kernels.quant``), dequantized in the
    kernel as each tile is loaded; the output takes the stream's dtype.

Positions are arange, as in the TPU kernel.  Any Sq / Sk runs: the kernel
masks ragged tails itself.  Each entry point is an operator
``torch.ops.repro_torch.<name>`` (``_build.define_op``): on CPU tensors it
runs the plain version (``kernels.ref``); on a CUDA device it launches the
kernel (built at first use) on the current stream, or raises — there is
no fallback.  ``launches`` counts kernel launches per kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (ref_attention, ref_flash_attention_merged,
                                     ref_flash_attention_merged_q8)

launches = {"flash_attention_bhsd": 0, "flash_attention_merged_bsd": 0,
            "flash_attention_merged_q8_bsd": 0}


def _launch(name, q, k, v, *, B, Hq, Hkv, Sq, Sk, q_strides, k_strides,
            causal, sliding_window, scales=(), strided=False):
    """Launch the flash body: fp K/V, or int8 K/V with their ``scales``
    (k_scale, v_scale), each (B, Sk // sg, Hkv); the output takes q's
    strides.  ``strided`` operands need only a dense last dimension."""
    D = q.shape[-1]
    dims = _build.HEAD_DIMS["flash_attention"]
    if scales:
        code = _build.check_q8_operands(name, q, (k, v), scales,
                                        head_dims=dims)
        n_sg = scales[0].shape[1]
        if any(tuple(s.shape) != (B, n_sg, Hkv) for s in scales) or \
                n_sg < 1 or Sk % n_sg:
            raise ValueError(f"{name}: scales must be (B, Sk // sg, Hkv) "
                             f"with sg | Sk={Sk}, got "
                             f"{[tuple(s.shape) for s in scales]}")
    else:
        code = _build.check_operands(name, (q, k, v), strided=strided,
                                     head_dims=dims)
    if Hq % Hkv:
        raise ValueError(f"{name}: {Hq} query heads over {Hkv} kv heads")
    out = torch.empty_like(q)  # q's strides: q is contiguous or dense
    if q.dtype == torch.bfloat16:
        _build.check_aligned(name, (q, k, v, out))
    lib = _build.library("flash_attention")
    args = (code, D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *(s.data_ptr() for s in scales), out.data_ptr(), B, Hq, Hkv, Sq,
            Sk, *q_strides, *k_strides, int(bool(causal)),
            int(sliding_window))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if scales:
        err = lib.flash_attention_q8_launch(*args, Sk // n_sg, stream)
    else:
        err = lib.flash_attention_launch(*args, stream)
    _build.check_launch(name, err)
    launches[name] += 1
    return out


# --------------------------------------------------------------------------
# the operators: CUDA implementations (checks, then one launch), plain
# versions on the CPU, and the output's shape and dtype for fake tensors
# --------------------------------------------------------------------------

_SCHEMA = ("(Tensor q, Tensor k, Tensor v, *, bool causal=True, "
           "int sliding_window=0) -> Tensor")
_Q8_SCHEMA = ("(Tensor q, Tensor k, Tensor v, Tensor k_scale, "
              "Tensor v_scale, *, bool causal=True, int sliding_window=0) "
              "-> Tensor")


def _fake(q, *args, **kw):
    return q.new_empty(q.shape)


def _bhsd_cuda(q, k, v, *, causal=True, sliding_window=0):
    name = "flash_attention_bhsd"
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Hkv, Sk, D) or k.shape != v.shape:
        raise ValueError(f"{name}: k/v must be (B, Hkv, Sk, D), got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return _launch(name, q, k, v, B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Sk=Sk,
                   q_strides=(Hq * Sq * D, D, Sq * D),
                   k_strides=(Hkv * Sk * D, D, Sk * D),
                   causal=causal, sliding_window=sliding_window)


def _bshd_cuda(q, k, v, *, causal=True, sliding_window=0):
    name = "flash_attention_bhsd"
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]

    def strides(t):  # (batch, seq, head); a size-1 dim's stride is unused
        return tuple(st if n > 1 else 0
                     for n, st in zip(t.shape[:3], t.stride()[:3]))

    if tuple(k.shape) != (B, Sk, Hkv, D) or k.shape != v.shape or \
            strides(k) != strides(v):
        raise ValueError(f"{name}: k/v must be (B, Sk, Hkv, D) with one "
                         f"set of strides, got {tuple(k.shape)} "
                         f"{k.stride()}, {tuple(v.shape)} {v.stride()}")
    if torch.empty_like(q).stride() != q.stride():
        q = q.contiguous()  # the output takes q's strides: q must be dense
    return _launch(name, q, k, v, B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Sk=Sk,
                   q_strides=strides(q), k_strides=strides(k),
                   causal=causal, sliding_window=sliding_window,
                   strided=True)


def _bshd_plain(q, k, v, *, causal=True, sliding_window=0):
    return ref_attention(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal,
                         sliding_window=sliding_window).transpose(1, 2)


def _merged_cuda(u, k, v, *scales, causal=True, sliding_window=0):
    name = "flash_attention_merged_q8_bsd" if scales \
        else "flash_attention_merged_bsd"
    B, Sq, Hq, D = u.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Sk, Hkv, D) or k.shape != v.shape:
        raise ValueError(f"{name}: k/v must be (B, Sk, Hkv, D), got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return _launch(name, u, k, v, B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Sk=Sk,
                   q_strides=(Sq * Hq * D, Hq * D, D),
                   k_strides=(Sk * Hkv * D, Hkv * D, D),
                   causal=causal, sliding_window=sliding_window,
                   scales=scales)


_OPS = {
    "flash_attention_bhsd": _build.define_op(
        "flash_attention_bhsd", _SCHEMA, cpu=ref_attention, cuda=_bhsd_cuda,
        fake=_fake),
    "flash_attention_bshd": _build.define_op(
        "flash_attention_bshd", _SCHEMA, cpu=_bshd_plain, cuda=_bshd_cuda,
        fake=_fake),
    "flash_attention_merged_bsd": _build.define_op(
        "flash_attention_merged_bsd", _SCHEMA,
        cpu=ref_flash_attention_merged, cuda=_merged_cuda, fake=_fake),
    "flash_attention_merged_q8_bsd": _build.define_op(
        "flash_attention_merged_q8_bsd", _Q8_SCHEMA,
        cpu=ref_flash_attention_merged_q8, cuda=_merged_cuda, fake=_fake),
}


# --------------------------------------------------------------------------
# the wrappers: the checks in front of each operator
# --------------------------------------------------------------------------

def flash_attention_bhsd(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    *,
    causal: bool = True,
    sliding_window: int = 0,
) -> torch.Tensor:
    """Generic flash attention -> (B, Hq, Sq, D)."""
    _build.check_call("flash_attention_bhsd", q, k, v)
    return _OPS["flash_attention_bhsd"](q, k, v, causal=bool(causal),
                                        sliding_window=int(sliding_window))


def flash_attention_bshd(
    q: torch.Tensor,  # (B, Sq, Hq, D), any strides, D dense
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    sliding_window: int = 0,
) -> torch.Tensor:
    """Generic flash attention on sequence-major views -> (B, Sq, Hq, D):
    the ``flash_attention_bhsd`` kernel launched on the tensors' own
    strides (no head-major copies), counted under its key."""
    _build.check_call("flash_attention_bhsd", q, k, v)
    return _OPS["flash_attention_bshd"](q, k, v, causal=bool(causal),
                                        sliding_window=int(sliding_window))


def flash_attention_merged_bsd(
    u: torch.Tensor,  # (B, Sq, Hq, D) — RoPE'd stream viewed as heads
    k: torch.Tensor,  # (B, Sk, Hkv, D) — K*, native layout
    v: torch.Tensor,  # (B, Sk, Hkv, D) — V*
    *,
    causal: bool = True,
    sliding_window: int = 0,
) -> torch.Tensor:
    """Merged flash prefill (stream-as-query) -> (B, Sq, Hq, D)."""
    _build.check_call("flash_attention_merged_bsd", u, k, v)
    return _OPS["flash_attention_merged_bsd"](
        u, k, v, causal=bool(causal), sliding_window=int(sliding_window))


def flash_attention_merged_q8_bsd(
    u: torch.Tensor,  # (B, Sq, Hq, D) — RoPE'd stream viewed as heads
    k: torch.Tensor,  # (B, Sk, Hkv, D) int8 — K* at pool quantization
    v: torch.Tensor,  # (B, Sk, Hkv, D) int8 — V*
    k_scale: torch.Tensor,  # (B, Sk // sg, Hkv) float32 per-(page, head)
    v_scale: torch.Tensor,  # (B, Sk // sg, Hkv) float32
    *,
    causal: bool = True,
    sliding_window: int = 0,
) -> torch.Tensor:
    """Merged flash prefill over int8 K*/V* (stream-as-query) ->
    (B, Sq, Hq, D) in u's dtype."""
    _build.check_call("flash_attention_merged_q8_bsd", u, k, v, k_scale,
                      v_scale)
    return _OPS["flash_attention_merged_q8_bsd"](
        u, k, v, k_scale, v_scale, causal=bool(causal),
        sliding_window=int(sliding_window))
