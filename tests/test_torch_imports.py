"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package ``repro``, and entry points never carry
on on the CPU when a card was asked for."""
import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _port_modules():
    import repro_torch
    names = ["repro_torch"]
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(m.name)
    return sorted(names)


def test_no_module_imports_jax_or_the_jax_package():
    """Every module of the port and chip_smoke.py import, in a fresh
    interpreter, with neither jax nor repro landing in sys.modules."""
    mods = _port_modules()
    assert {"repro_torch.kernels.ops", "repro_torch.serving.engine",
            "repro_torch.core.merge", "repro_torch.launch.serve",
            "repro_torch.launch.train", "repro_torch.training.checkpoint",
            "repro_torch.training.data", "repro_torch.training.optimizer",
            "repro_torch.training.fault_tolerance",
            "repro_torch.training.train_loop"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{SRC!r}, {ROOT!r}]\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0 and r.stdout.startswith("ok"), r.stdout + r.stderr


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_statement_names_jax_or_the_jax_package(path):
    """An AST scan, so an import inside a function body counts too."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, (path, node.lineno, n)


def test_cuda_entry_points_raise_without_a_card():
    """device='cuda' (the default) raises instead of carrying on on the
    CPU; the decision is made here, inside the test."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.convert import to_torch
    from repro_torch.models import init_cache, init_params
    from repro_torch.serving import Engine, ServeConfig

    cfg = reduce_config(get_config("mistral-7b"))
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="cuda"):
        to_torch({"w": [1.0]})
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(cfg, params, ServeConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        from repro_torch.launch.serve import main
        main(["--arch", "mistral-7b", "--smoke"])


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert r.returncode != 0 and '"ok"' not in r.stdout, r.stdout


def test_engine_refuses_impl_device_mismatch():
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, ServeConfig

    cfg = reduce_config(get_config("mistral-7b"))
    params = init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="impl='cuda'"):
        Engine(cfg, params, ServeConfig(), impl="cuda", device="cpu")
    with pytest.raises(ValueError, match="impl='torch'"):
        Engine(cfg, params, ServeConfig(), impl="torch", device="cuda")
    with pytest.raises(KeyError, match="registered combos"):
        Engine(cfg, params, ServeConfig(), impl="xla", device="cpu")


def test_kernel_wrappers_take_the_plain_version_only_on_the_cpu():
    """On CPU tensors the wrappers run the plain version (and count no
    launch); mixed devices raise rather than fall back."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    u = torch.randn(2, 4, 64)
    k = torch.randn(2, 8, 2, 64)
    kvp = torch.arange(8, dtype=torch.int32).expand(2, 8).contiguous()
    qp = torch.tensor([7, 3], dtype=torch.int32)
    out = dk.decode_attention_merged_bsd(u, k, k, kvp, qp)
    assert out.shape == u.shape and torch.isfinite(out).all()
    assert sum(launch_counts().values()) == 0
    with pytest.raises(ValueError, match="several devices"):
        dk.decode_attention_merged_bsd(u, k, k, kvp, qp.to("meta"))
