"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` launch functions (no
PyTorch headers), so one nvcc call per source builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so <name>.cu

The library lands in ``kernels/_build/`` (listed in ``.gitignore``), named
by a hash of its source, so an edited source is rebuilt and an unchanged
one is built once per checkout.  Nothing is built at import: the first
wrapper call on a CUDA tensor builds what it needs; ``build_all`` starts one
nvcc per source at once.  A failed build raises with nvcc's output.

Each kernel entry point is an operator of the ``repro_torch`` namespace
(``define_op``, ``torch.ops.repro_torch.<name>``): PyTorch's dispatcher
runs the plain version on CPU tensors and the kernel launch on CUDA ones,
and a traced program (``torch.fx``) holds each call as one node, as a
jaxpr holds a ``pallas_call`` as one equation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("decode_attention", "flash_attention", "ssd_scan")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the C signatures of the launch functions, as ctypes argtypes: pointers
# and the stream are c_void_p, strides of the SSD scan c_longlong,
# everything else c_int
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "decode_attention": {
        # ... then the partial-state outputs (m, l, o) and the stream
        "decode_attention_launch": [_I, _I] + [_P] * 6 + [_I] * 12
        + [_P] * 4,
        "decode_attention_paged_launch": [_I, _I] + [_P] * 6 + [_I] * 11
        + [_P] * 4,
        "decode_attention_paged_q8_launch": [_I, _I] + [_P] * 8
        + [_I] * 11 + [_P] * 4,
        "decode_attention_occupancy": [_I] * 5 + [_P],
    },
    "flash_attention": {
        "flash_attention_launch": [_I, _I] + [_P] * 4 + [_I] * 13 + [_P],
        "flash_attention_q8_launch": [_I, _I] + [_P] * 6 + [_I] * 14 + [_P],
    },
    "ssd_scan": {
        "ssd_scan_launch": [_I, _I] + [_P] * 7 + [_I] * 4 + [_LL] * 9 + [_P],
        "ssd_scan_occupancy": [_I] * 4 + [_P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas register / shared-memory report) per built source
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.exists():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built from source at first use")
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is already built;
    returns (target, Popen or None)."""
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, (proc, tmp, cmd)


def _finish(name: str, target: Path, job) -> None:
    if job is not None:
        proc, tmp, cmd = job
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed building {name}.cu (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{out}")
        os.replace(tmp, target)
    lib = ctypes.CDLL(str(target))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _libs[name] = lib


def build_all(names: List[str] = SOURCES) -> None:
    """Build (in parallel: one nvcc per source, all started together) and
    load every named source not loaded yet."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        jobs = [(n, *_start(n)) for n in todo]
        errors = []
        for n, target, job in jobs:  # reap every nvcc before raising
            try:
                _finish(n, target, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    if name not in _libs:
        build_all([name])
    return _libs[name]


# --------------------------------------------------------------------------
# what every wrapper checks before handing pointers to a launch function
# --------------------------------------------------------------------------

DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}
# the head dims each attention source instantiates: flash also takes
# HuBERT-XLarge's 80 (an encoder: no decode path needs it)
HEAD_DIMS = {"flash_attention": (64, 80, 128),
             "decode_attention": (64, 128)}


def refuse_autograd(name: str, *tensors) -> None:
    """Raise RuntimeError where autograd would have to differentiate
    through a kernel: none has a backward, and the output a wrapper builds
    (``torch.empty_like``) carries no ``grad_fn``, so the gradient would
    vanish without a word.  Train through ``impl="torch"``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an operand requires grad, but the CUDA kernel has no "
            "backward; run it under torch.no_grad() or train with "
            "impl='torch'")


def refuse_placed(name: str, *args) -> None:
    """Raise TypeError for a DTensor operand: a kernel takes the local
    tensors of one rank (``distribution.placed.local_call``), and nothing
    may gather a placed tensor quietly to run it."""
    for a in args:
        if type(a).__name__ == "DTensor":
            raise TypeError(
                f"{name}: got a DTensor; kernel wrappers take plain tensors "
                "(under a mesh the attention cores hand them each rank's "
                "local shards)")


def check_call(name: str, *tensors) -> None:
    """What every wrapper checks in front of its operator: no DTensor
    (``refuse_placed``), every tensor on one CUDA device, every one on
    the CPU or every one on the meta device (mixed devices raise: the
    dispatcher would pick the CUDA implementation and hand it host
    pointers), and no CUDA operand that autograd would need to
    differentiate (``refuse_autograd``).  On the CPU the operator runs
    its plain version, which autograd differentiates (``define_op``); on
    the meta device its fake gives the results' shapes (a dry run: no
    launch, none counted)."""
    refuse_placed(name, *tensors)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if dev.type == "cuda":
        refuse_autograd(name, *tensors)


# --------------------------------------------------------------------------
# each kernel entry point is one operator of the ``repro_torch`` namespace
# --------------------------------------------------------------------------

_LIB = torch.library.Library("repro_torch", "FRAGMENT")
#: the defined operators, ``torch.ops.repro_torch.<name>``, in order
OPS: List[str] = []


def define_op(name: str, schema: str, *, cpu, cuda, fake):
    """Define the operator ``repro_torch::<name>`` with ``schema`` (its
    arguments and results, e.g. ``"(Tensor q, *, int w=0) -> Tensor"``):
    ``cpu`` (the plain version) runs on CPU tensors, ``cuda`` (checks and
    the kernel launch, which counts it) on CUDA tensors, and ``fake``
    gives the results' shapes and dtypes without data (fake and meta
    tensors).  Returns ``torch.ops.repro_torch.<name>``.

    The operator is functional: its results are fresh tensors and it
    writes none of its inputs, so the layout plumbing around it (views,
    transposes, ``.contiguous()``) stays ordinary aten ops of the
    caller's.  Its gradient is the plain version's (``_plain_backward``):
    on the CPU autograd differentiates the operator as it did the plain
    version; CUDA operands that require grad are refused in front of it
    (``check_call``), so a CUDA call skips autograd."""
    _LIB.define(name + schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    qualname = f"repro_torch::{name}"
    torch.library.register_fake(qualname, fake, lib=_LIB)
    torch.library.register_autograd(qualname, _plain_backward(cpu),
                                    setup_context=_save_inputs, lib=_LIB)
    # CUDA operands that require grad never reach the operator: skip the
    # (Python) autograd layer on CUDA calls, ~10 us of host time each
    _LIB.impl(name, torch.library.fallthrough_kernel, "AutogradCUDA")
    OPS.append(name)
    return getattr(torch.ops.repro_torch, name)


def _save_inputs(ctx, inputs, keyword_only_inputs, output):
    ctx.save_for_backward(*inputs)
    ctx.kw = keyword_only_inputs


def _plain_backward(plain):
    """The backward of an operator: the vector-Jacobian product of its
    plain version ``plain``, recomputed from the saved inputs."""
    def backward(ctx, *grads):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() if t.is_floating_point()
                      and need else t.detach()
                      for t, need in zip(ctx.saved_tensors,
                                         ctx.needs_input_grad)]
            out = plain(*leaves, **ctx.kw)
            outs = out if isinstance(out, tuple) else (out,)
            wrt = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(
                [o for o, g in zip(outs, grads) if g is not None], wrt,
                [g for g in grads if g is not None], allow_unused=True))
        return tuple(next(got) if t.requires_grad else None for t in leaves)
    return backward


def _check_layout(name: str, tensors, strided: bool = False) -> None:
    """Contiguous operands (``strided``: any strides, the last dimension
    dense) whose elements lie within int32 offsets."""
    for t in tensors:
        if not (t.stride(-1) == 1 if strided else t.is_contiguous()):
            where = " in their last dimension" if strided else ""
            raise ValueError(f"{name}: operands must be contiguous{where}")
        span = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
        if max(span, t.numel()) >= 2 ** 31:
            raise ValueError(f"{name}: operand too large for int32 offsets")


def check_operands(name: str, data, ints=(), strided: bool = False,
                   head_dims=HEAD_DIMS["decode_attention"]) -> int:
    """Checks dtype, layout (``_check_layout``) and int32 addressability of
    the float operands ``data`` (one dtype, float32 or bfloat16) and the
    int32 operands ``ints``, and that the head dim is one of
    ``head_dims``; returns the dtype code the launch function takes."""
    dt = data[0].dtype
    if any(t.dtype != dt for t in data) or str(dt) not in DTYPE_CODES:
        raise ValueError(f"{name}: float operands must share float32 or "
                         f"bfloat16, got {[t.dtype for t in data]}")
    _check_layout(name, data, strided)
    _check_layout(name, ints)
    for t in ints:
        if str(t.dtype) != "torch.int32":
            raise ValueError(f"{name}: position and table operands must be "
                             f"int32, got {t.dtype}")
    if data[0].shape[-1] not in head_dims:
        raise ValueError(f"{name}: head dim {data[0].shape[-1]} not in "
                         f"{head_dims}")
    return DTYPE_CODES[str(dt)]


def check_q8_operands(name: str, q, pools, scales, ints=(),
                      head_dims=HEAD_DIMS["decode_attention"]) -> int:
    """``check_operands`` for an int8 operation: the query ``q`` (float32
    or bfloat16, whose code is returned), int8 ``pools`` of its head dim
    and their float32 ``scales``."""
    code = check_operands(name, (q,), ints, head_dims=head_dims)
    if any(str(t.dtype) != "torch.int8" for t in pools) or \
            any(str(t.dtype) != "torch.float32" for t in scales):
        raise ValueError(f"{name}: K/V must be int8 and their scales "
                         f"float32, got {[t.dtype for t in pools]}, "
                         f"{[t.dtype for t in scales]}")
    _check_layout(name, (*pools, *scales))
    if any(t.shape[-1] != q.shape[-1] for t in pools):
        raise ValueError(f"{name}: K/V head dim differs from the query's "
                         f"{q.shape[-1]}")
    return code


def check_aligned(name: str, tensors) -> None:
    """Operands of a kernel that moves 16-byte chunks (the bf16 flash
    body, the decode body's K/V, the SSD scan's x, B and C): each pointer
    16-byte aligned, each
    stride but the last a whole number of 16 bytes (a dimension of size 1
    has no stride to check)."""
    for t in tensors:
        if t.data_ptr() % 16 or any(
                n > 1 and st * t.element_size() % 16
                for n, st in zip(t.shape[:-1], t.stride()[:-1])):
            raise ValueError(f"{name}: operands copied in 16-byte chunks "
                             f"need 16-byte aligned pointers and strides, "
                             f"got strides {t.stride()} of {t.dtype}")


def check_launch(name: str, err: int) -> None:
    """Raise if a launch function returned a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
