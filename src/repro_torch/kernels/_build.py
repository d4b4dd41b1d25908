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

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("decode_attention", "flash_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the C signatures of the launch functions, as ctypes argtypes: pointers
# and the stream are c_void_p, everything else c_int
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "decode_attention": {
        "decode_attention_launch": [_I, _I] + [_P] * 8 + [_I] * 12 + [_P],
    },
    "flash_attention": {
        "flash_attention_launch": [_I, _I] + [_P] * 4 + [_I] * 13 + [_P],
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
HEAD_DIMS = (64, 128)


def on_cuda(name: str, *tensors) -> bool:
    """True when every tensor lies on one CUDA device, False when every one
    lies on the CPU (the wrapper then runs its plain version); mixed
    devices raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def check_operands(name: str, data, ints=()) -> int:
    """Checks dtype, contiguity and int32 addressability of the float
    operands ``data`` (one dtype, float32 or bfloat16) and the int32
    operands ``ints``; returns the dtype code the launch function takes."""
    dt = data[0].dtype
    if any(t.dtype != dt for t in data) or str(dt) not in DTYPE_CODES:
        raise ValueError(f"{name}: float operands must share float32 or "
                         f"bfloat16, got {[t.dtype for t in data]}")
    for t in (*data, *ints):
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{name}: operand too large for int32 offsets")
    for t in ints:
        if str(t.dtype) != "torch.int32":
            raise ValueError(f"{name}: position operands must be int32, "
                             f"got {t.dtype}")
    if data[0].shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {data[0].shape[-1]} not in "
                         f"{HEAD_DIMS}")
    return DTYPE_CODES[str(dt)]


def check_launch(name: str, err: int) -> None:
    """Raise if a launch function returned a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
