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
            "repro_torch.training.train_loop",
            "repro_torch.configs.shapes", "repro_torch.distribution",
            "repro_torch.distribution.sharding",
            "repro_torch.distribution.placed", "repro_torch.launch.mesh",
            "repro_torch.launch.steps",
            "repro_torch.launch.dryrun", "repro_torch.lint",
            "repro_torch.lint.walker", "repro_torch.lint.rules",
            "repro_torch.lint.builtin", "repro_torch.lint.sweep",
            "repro_torch.lint.aliasing", "repro_torch.lint.submitpath",
            "repro_torch.lint.retention", "repro_torch.lint.report",
            "repro_torch.lint.__main__"} <= set(mods)
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


def test_lint_cli_raises_without_a_card_unless_asked_for_the_cpu():
    """``python -m repro_torch.lint`` runs on the card by default: without
    one it raises before any work; ``--list-rules`` needs no device."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-m", "repro_torch.lint", "--sweep"],
                       capture_output=True, text=True, timeout=120,
                       cwd=ROOT, env=env)
    assert r.returncode != 0 and "RuntimeError" in r.stderr \
        and "cuda" in r.stderr, r.stdout + r.stderr
    assert "sweep" not in r.stdout
    from repro_torch.lint.__main__ import main
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--retention"])
    r = subprocess.run([sys.executable, "-m", "repro_torch.lint",
                        "--list-rules"], capture_output=True, text=True,
                       timeout=120, cwd=ROOT, env=env)
    assert r.returncode == 0 and "NoForbiddenMatmul" in r.stdout


def test_importing_the_dry_run_changes_no_environment():
    """Unlike the reference's (which sets XLA_FLAGS on import), the port's
    dry run leaves the process environment as it found it."""
    code = (
        "import os, sys\n"
        f"sys.path[:0] = [{SRC!r}]\n"
        "before = dict(os.environ)\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.steps\n"
        "import repro_torch.launch.mesh, repro_torch.distribution\n"
        "assert dict(os.environ) == before\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0 and r.stdout.startswith("ok"), r.stdout + r.stderr


def test_shape_helpers_build_on_meta_and_entry_points_refuse_it():
    """``param_shapes`` / ``launch.steps`` make their trees on the meta
    device; ``init_params``, ``init_cache`` and the engine refuse it."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.launch import steps
    from repro_torch.models import init_cache, init_params, param_shapes
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.training import DataConfig, Trainer, TrainerConfig

    cfg = reduce_config(get_config("mistral-7b"))
    meta = param_shapes(cfg)
    plain = init_params(cfg, device="cpu")
    import repro_torch._tree as tr
    assert [tuple(x.shape) for x in tr.tree_leaves(meta)] == \
        [tuple(x.shape) for x in tr.tree_leaves(plain)]
    assert all(x.device.type == "meta" for x in tr.tree_leaves(meta))
    assert steps.cache_specs(cfg, 2, 16).k.device.type == "meta"
    with pytest.raises(ValueError, match="meta"):
        init_params(cfg, device="meta")
    with pytest.raises(ValueError, match="meta"):
        init_cache(cfg, 2, 16, device="meta")
    with pytest.raises(ValueError, match="meta"):
        Engine(cfg, plain, ServeConfig(), impl="torch", device="meta")
    with pytest.raises(ValueError, match="meta"):
        Trainer(cfg, TrainerConfig(), DataConfig(global_batch=2, seq_len=8),
                device="meta")


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
