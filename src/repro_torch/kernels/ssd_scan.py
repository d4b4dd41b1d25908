"""Mamba2 SSD chunked scan: the wrapper of ``csrc/ssd_scan.cu``.

Counterpart of ``repro.kernels.ssd_scan.ssd_scan_pallas``: from a zero
state, y (B, S, H, P) float32 and the final state (B, H, P, N) float32 of
the recurrence ``S_t = exp(a_t) S_{t-1} + dt_t x_t B_tᵀ``, ``y_t = S_t C_t``.
Inputs are pre-activated as the TPU kernel takes them: dt is post-softplus
and a = dt·A, both float32; x, Bm and Cm share float32 or bfloat16.  The
D skip, the gate and the norm live in ``kernels.ops.ssd_scan`` and
``models.mamba2``.

``chunk`` is the caller's chunk (the reference tiles by it: ``chunk`` rows
if that divides S, else one chunk of S).  The CUDA kernel tiles by its own
64 rows whatever ``chunk`` says, the same recurrence up to rounding; the
plain version (``kernels.ref.ref_ssd_chunked``) tiles as the reference
does.  B and C may come broadcast from their groups with a zero head
stride: the kernel takes strides, so the repeat is never materialised.
The kernel reads x, B and C rows in 16-byte pieces, so N is a multiple of
8 and their pointers and strides are 16-byte aligned.

The kernel cuts the sequence of each (batch, head) into ``ssd_split(S)``
spans of whole 64-row tiles, the blocks of one thread-block cluster, which
pass their states to each other inside the one launch (see the CUDA
source).

The entry point is the operator ``torch.ops.repro_torch.ssd_chunk_scan``
(``_build.define_op``): on CPU tensors it runs the plain version; on a
CUDA device it launches the kernel (built at first use) on the current
stream, or raises — there is no fallback.  ``launches`` counts kernel
launches: one per call on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_ssd_chunked

launches = {"ssd_chunk_scan": 0}

HEAD_DIMS = (16, 32, 64, 128)
MAX_STATE = 128
TILE = 64  # rows of the kernel's tile
MAX_SPAN = 8  # spans of one (batch, head): one thread-block cluster


def ssd_split(S: int):
    """(n_span, span_rows): the kernel's cut of a sequence of ``S`` rows
    into at most ``MAX_SPAN`` spans of whole ``TILE``-row tiles, one span
    per tile up to that cap, none empty (``ssd_split`` in the CUDA
    source)."""
    tiles = max(1, -(-S // TILE))
    per = -(-tiles // min(MAX_SPAN, tiles))
    return -(-tiles // per), per * TILE


def occupancy(dtype: torch.dtype, P: int, N: int, S: int):
    """Residency on the card of the kernel that a call over ``S`` rows
    launches for inputs of ``dtype``, head dim ``P`` and state ``N``:
    (blocks per SM, clusters resident at once, dynamic shared memory bytes
    per block, n_span, span_rows)."""
    res = (ctypes.c_int * 5)()
    lib = _build.library("ssd_scan")
    err = lib.ssd_scan_occupancy(_build.DTYPE_CODES[str(dtype)], P, N, S,
                                 ctypes.addressof(res))
    _build.check_launch("ssd_scan_occupancy", err)
    return tuple(res)


def _max_offset(t: torch.Tensor) -> int:
    return sum((n - 1) * s for n, s in zip(t.shape, t.stride()) if n)


def _scan_cuda(x, dt, a, Bm, Cm, *, chunk):
    name = "ssd_chunk_scan"
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(dt.shape) != (B, S, H) or dt.shape != a.shape:
        raise ValueError(f"{name}: dt and a must be (B, S, H) = "
                         f"{(B, S, H)}, got {tuple(dt.shape)}, "
                         f"{tuple(a.shape)}")
    if tuple(Bm.shape) != (B, S, H, N) or Bm.shape != Cm.shape or \
            Bm.stride() != Cm.stride():
        raise ValueError(f"{name}: Bm and Cm must be (B, S, H, N) with one "
                         f"set of strides, got {tuple(Bm.shape)} "
                         f"{Bm.stride()}, {tuple(Cm.shape)} {Cm.stride()}")
    if x.dtype != Bm.dtype or Bm.dtype != Cm.dtype or \
            str(x.dtype) not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: x, Bm and Cm must share float32 or "
                         f"bfloat16, got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"{name}: dt and a must be float32, got {dt.dtype}, "
                         f"{a.dtype}")
    if P not in HEAD_DIMS or not 8 <= N <= MAX_STATE or N % 8:
        raise ValueError(f"{name}: head dim {P} not in {HEAD_DIMS} or state "
                         f"{N} not a multiple of 8 in [8, {MAX_STATE}]")
    if x.stride(-1) != 1 or Bm.stride(-1) != 1 or not dt.is_contiguous() \
            or not a.is_contiguous():
        raise ValueError(f"{name}: x, Bm and Cm need a contiguous last dim "
                         "and dt, a contiguous tensors")
    if any(_max_offset(t) >= 2 ** 31 for t in (x, dt, Bm)):
        raise ValueError(f"{name}: operand too large for the kernel")
    _build.check_aligned(name, (x, Bm, Cm))
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    fin = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    lib = _build.library("ssd_scan")
    err = lib.ssd_scan_launch(
        _build.DTYPE_CODES[str(x.dtype)], P, x.data_ptr(), dt.data_ptr(),
        a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
        fin.data_ptr(), B, S, H, N, *x.stride()[:3], *dt.stride(),
        *Bm.stride()[:3], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(name, err)
    launches[name] += 1
    return y, fin


def _scan_fake(x, dt, a, Bm, Cm, *, chunk):
    B, S, H, P = x.shape
    return (x.new_empty((B, S, H, P), dtype=torch.float32),
            x.new_empty((B, H, P, Bm.shape[-1]), dtype=torch.float32))


_OP = _build.define_op(
    "ssd_chunk_scan", "(Tensor x, Tensor dt, Tensor a, Tensor Bm, Tensor Cm, "
    "*, int chunk) -> (Tensor, Tensor)", cpu=ref_ssd_chunked,
    cuda=_scan_cuda, fake=_scan_fake)


def ssd_chunk_scan(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) float32, post-softplus
    a: torch.Tensor,  # (B, S, H) float32, = dt * A (<= 0)
    Bm: torch.Tensor,  # (B, S, H, N)
    Cm: torch.Tensor,  # (B, S, H, N), Bm's strides
    *,
    chunk: int,
):
    """Returns (y (B,S,H,P) float32, final_state (B,H,P,N) float32)."""
    _build.check_call("ssd_chunk_scan", x, dt, a, Bm, Cm)
    return _OP(x, dt, a, Bm, Cm, chunk=int(chunk))
