"""The port's training substrate (``repro_torch.training``: lm_loss,
optimizers, schedules, data, checkpoints, Trainer, the launcher) held
against ``repro.training`` and ``repro.models.lm_loss``.

Tolerances: ``lm_loss`` and its gradient 1e-6 relative (float32 on both
sides); AdamW and Lion updates from identical gradients 1e-6 absolute on
O(1) params (three steps, clipping and decay on); schedules 1e-6
relative at steps 0-50; data batches and checkpoint leaves bit for bit; a
JAX Trainer's checkpoint resumed by the port's Trainer logs the losses of
the JAX run that went straight through within 1e-4 relative (the two
forwards sum in other orders, and at AdamW's first steps an element whose
gradient is at rounding level can take the other sign).
"""
import contextlib
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import models as jm
from repro import training as jtr
from repro.training import checkpoint as jck
from repro.training import optimizer as jopt
from repro_torch import configs as tcfg
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.kernels import _build
from repro_torch.models import lm_loss
from repro_torch.training import (DataConfig, Trainer, TrainerConfig,
                                  checkpoint, make_loss_fn)
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


# ---------------------------------------------------------------------------
# lm_loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab_size,z_loss,n_ignored", [
    (100, 1e-4, 3),  # padded vocab: logits of ids 100..127 masked
    (128, 1e-4, 0),
    (128, 0.0, 5)])
def test_lm_loss_and_its_gradient_match_jax(vocab_size, z_loss, n_ignored):
    rng = np.random.default_rng(vocab_size + n_ignored)
    logits = (3 * rng.standard_normal((2, 7, 128))).astype(np.float32)
    labels = rng.integers(0, vocab_size, (2, 7)).astype(np.int32)
    labels.reshape(-1)[rng.permutation(14)[:n_ignored]] = -100

    def jf(x):
        return jm.lm_loss(x, jnp.asarray(labels), z_loss=z_loss,
                          vocab_size=vocab_size)
    want, want_g = jax.value_and_grad(jf)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = lm_loss(x, torch.from_numpy(labels), z_loss=z_loss,
                  vocab_size=vocab_size)
    got.backward()
    assert _rel(got.detach(), want) <= 1e-6
    scale = float(np.abs(want_g).max())
    assert float(np.abs(x.grad.numpy() - np.asarray(want_g)).max()) <= \
        1e-6 * scale
    if vocab_size < 128:  # no gradient reaches the padded ids
        assert not x.grad[..., vocab_size:].any()


def test_lm_loss_all_ignored_is_zero():
    x = torch.randn(1, 3, 16)
    assert float(lm_loss(x, torch.full((1, 3), -100))) == 0.0


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------

def _opt_tree(rng):
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "stack": {"scale": rng.standard_normal((2, 4)).astype(np.float32),
                      "b": rng.standard_normal((5,)).astype(np.float32)}}


@pytest.mark.parametrize("name", ["adamw", "lion"])
def test_optimizer_updates_match_jax(name):
    """Three updates from identical gradients (global-norm clipping active,
    decay on the 2-D leaves, one gradient missing: zeros in JAX, None in
    the port), then params and state compared."""
    rng = np.random.default_rng(1)
    params = _opt_tree(rng)
    grads = [_opt_tree(rng) for _ in range(3)]
    jo = jopt.make_optimizer(name, 1e-2, 2, 10, weight_decay=0.1,
                             clip_norm=1.0)
    to = topt.make_optimizer(name, 1e-2, 2, 10, weight_decay=0.1,
                             clip_norm=1.0)
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    tp = tree_map(torch.from_numpy, jax.tree.map(np.copy, params))
    ts = to.init(tp)
    for g in grads:
        g["stack"]["b"] = np.zeros_like(g["stack"]["b"])
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tg = tree_map(torch.from_numpy, g)
        tg["stack"]["b"] = None
        tp, ts = to.update(tg, ts, tp)
    assert type(ts).__name__ == type(js).__name__
    assert ts.step.dtype == torch.int32 and ts.step.shape == () and \
        int(ts.step) == int(js.step) == 3
    for field in js._fields[1:]:
        for a, b in zip(tree_leaves(getattr(ts, field)),
                        jax.tree.leaves(getattr(js, field))):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


def test_global_norm_matches_jax():
    tree = _opt_tree(np.random.default_rng(2))
    want = float(jopt.global_norm(jax.tree.map(jnp.asarray, tree)))
    assert _rel(topt.global_norm(tree_map(torch.from_numpy, tree)),
                want) <= 1e-6


@pytest.mark.parametrize("sched", [
    ("cosine_schedule", (3e-4, 10, 40)),
    ("cosine_schedule", (1e-3, 0, 50, 0.0)),
    ("linear_schedule", (2e-3, 5, 30)),
    ("constant_schedule", (7e-4,))])
def test_schedules_match_jax_at_steps_0_to_50(sched):
    name, args = sched
    jf, tf = getattr(jopt, name)(*args), getattr(topt, name)(*args)
    for s in range(51):
        want = float(jf(jnp.int32(s)))
        got = tf(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1e-12), s


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mistral-7b", "hubert-xlarge",
                                  "llama3.2-vision-11b"])
def test_synthetic_batches_equal_the_reference(arch):
    jc = jcfg.reduce_config(jcfg.get_config(arch))
    tc = tcfg.reduce_config(tcfg.get_config(arch))
    for host in (0, 1):
        dc = dict(global_batch=4, seq_len=9, seed=5, host_id=host, n_hosts=2)
        a = jtr.make_dataset(jc, jtr.DataConfig(**dc)).batch_at(7)
        b = tdata.make_dataset(tc, DataConfig(**dc)).batch_at(7)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_byte_corpus_batches_equal_the_reference(tmp_path):
    p = tmp_path / "corpus.txt"
    p.write_bytes(b"kv-weights are all you need " * 40)
    jc = jcfg.reduce_config(jcfg.get_config("llama3.2-1b"))
    tc = tcfg.reduce_config(tcfg.get_config("llama3.2-1b"))
    dc = dict(global_batch=3, seq_len=12, seed=2)
    a = jtr.make_dataset(jc, jtr.DataConfig(**dc), str(p)).batch_at(4)
    b = tdata.make_dataset(tc, DataConfig(**dc), str(p)).batch_at(4)
    for k in ("inputs", "labels"):
        np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# checkpoints: the reference's format, both ways
# ---------------------------------------------------------------------------

def _ckpt_trees(rng):
    """The same state as a port tree and as a JAX tree: float32 and bf16
    leaves and an optimizer NamedTuple with a 0-d int32 step."""
    w = rng.standard_normal((3, 5)).astype(np.float32)
    b = rng.standard_normal((4,)).astype(np.float32)
    mu = rng.standard_normal((3, 5)).astype(np.float32)
    tw = torch.from_numpy(w)
    tb = torch.from_numpy(b).to(torch.bfloat16)
    port = {"params": {"w": tw, "nest": {"b": tb}},
            "opt": topt.AdamWState(torch.tensor(7, dtype=torch.int32),
                                   {"w": torch.from_numpy(mu),
                                    "nest": {"b": torch.zeros(4)}},
                                   {"w": torch.ones(3, 5),
                                    "nest": {"b": torch.ones(4)}})}
    jb = jnp.asarray(tb.float().numpy()).astype(jnp.bfloat16)  # exact
    jaxt = {"params": {"w": jnp.asarray(w), "nest": {"b": jb}},
            "opt": jopt.AdamWState(jnp.int32(7),
                                   {"w": jnp.asarray(mu),
                                    "nest": {"b": jnp.zeros(4)}},
                                   {"w": jnp.ones((3, 5)),
                                    "nest": {"b": jnp.ones(4)}})}
    return port, jaxt


def _bits(x):
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same_bits(a_leaves, b_leaves):
    assert len(a_leaves) == len(b_leaves)
    for a, b in zip(a_leaves, b_leaves):
        a, b = _bits(a), _bits(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _port_leaves(tree):
    return [leaf for _, leaf in checkpoint._walk(tree)]


def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    port, jaxt = _ckpt_trees(np.random.default_rng(3))
    checkpoint.save(str(tmp_path / "t"), 4, port, metadata={"by": "torch"})
    jck.save(str(tmp_path / "j"), 4, jaxt, metadata={"by": "torch"})
    # the same manifest and the same npz keys, in the same order
    mt = checkpoint.read_manifest(str(tmp_path / "t"), 4)
    mj = jck.read_manifest(str(tmp_path / "j"), 4)
    for k in ("step", "keys", "shapes", "dtypes", "metadata"):
        assert mt[k] == mj[k], k
    assert "opt/mu/nest/b" in mt["keys"] and mt["dtypes"]["opt/step"] == \
        "int32" and mt["dtypes"]["params/nest/b"] == "bfloat16"
    with np.load(tmp_path / "t" / "step_00000004" / "arrays.npz") as zt, \
            np.load(tmp_path / "j" / "step_00000004" / "arrays.npz") as zj:
        assert zt.files == zj.files
    step, got = jck.restore_latest(str(tmp_path / "t"), jaxt)
    assert step == 4
    _same_bits(jax.tree.leaves(got), _port_leaves(port))


def test_jax_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    port, jaxt = _ckpt_trees(np.random.default_rng(4))
    jck.save(str(tmp_path / "j"), 9, jaxt)
    like = tree_map(lambda t: torch.zeros_like(t), port["params"])
    like = {"params": like, "opt": topt.AdamWState(
        torch.zeros((), dtype=torch.int32), *port["opt"][1:])}
    step, got = checkpoint.restore_latest(str(tmp_path / "j"), like)
    assert step == 9 and isinstance(got["opt"], topt.AdamWState)
    assert got["params"]["nest"]["b"].dtype == torch.bfloat16
    assert got["opt"].step.dtype == torch.int32 and got["opt"].step.shape == ()
    _same_bits(_port_leaves(got), jax.tree.leaves(jaxt))


def test_restore_refuses_a_mismatched_tree(tmp_path):
    port, _ = _ckpt_trees(np.random.default_rng(5))
    checkpoint.save(str(tmp_path), 1, port)
    bad = {"params": {"w": torch.zeros(5, 3), "nest": {"b": torch.zeros(4)}}}
    with pytest.raises(ValueError, match="params/w"):
        checkpoint.restore(str(tmp_path), 1, bad)
    with pytest.raises(KeyError, match="params/v"):
        checkpoint.restore(str(tmp_path), 1, {"params": {"v": torch.zeros(1)}})


def test_checkpoint_gc_latest_and_atomicity(tmp_path):
    d = str(tmp_path / "ck")
    port, _ = _ckpt_trees(np.random.default_rng(6))
    for s in (1, 2, 3, 4):
        checkpoint.save(d, s, port, keep=2)
    assert sorted(x for x in os.listdir(d) if x.startswith("step_")) == \
        ["step_00000003", "step_00000004"]
    assert checkpoint.latest_step(d) == 4
    # a crashed save leaves a temp dir, which restore never sees
    os.makedirs(os.path.join(d, ".tmp.step_00000005.0"))
    assert checkpoint.latest_step(d) == 4
    # no LATEST: the newest step directory
    os.remove(os.path.join(d, "LATEST"))
    assert checkpoint.latest_step(d) == 4
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    assert checkpoint.restore_latest(str(tmp_path / "none"), port) == \
        (None, port)


def test_async_checkpoint_snapshots_before_the_next_update(tmp_path):
    """The write runs in a thread, but what it writes is the state at the
    call: an in-place update right after cannot reach it."""
    d = str(tmp_path / "ck")
    port, _ = _ckpt_trees(np.random.default_rng(7))
    want = port["params"]["w"].clone()
    ac = checkpoint.AsyncCheckpointer(d, keep=2)
    ac.save(3, port)
    port["params"]["w"].add_(1.0)  # the optimizer's next in-place update
    ac.wait()
    assert checkpoint.latest_step(d) == 3
    got = checkpoint.restore(d, 3, port)
    assert torch.equal(got["params"]["w"], want)


def test_async_checkpoint_error_surfaces_on_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ac = checkpoint.AsyncCheckpointer(str(blocker / "ck"))
    ac.save(1, {"w": torch.zeros(2)})
    with pytest.raises(OSError):
        ac.wait()


# ---------------------------------------------------------------------------
# Trainer and launcher
# ---------------------------------------------------------------------------

def _llama():
    return (jcfg.reduce_config(jcfg.get_config("llama3.2-1b")),
            tcfg.reduce_config(tcfg.get_config("llama3.2-1b")))


def test_trainer_resume_bitexact(tmp_path):
    """6 steps straight == 3 steps, a checkpoint, a new Trainer, 3 more:
    every param equal bit for bit."""
    _, cfg = _llama()
    dc = DataConfig(global_batch=4, seq_len=16, seed=0)
    kw = dict(steps=6, log_every=3, ckpt_every=3, lr=1e-3, warmup=1)
    tr = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "a"), **kw), dc,
                 device="cpu")
    tr.run()
    d = str(tmp_path / "b")
    Trainer(cfg, TrainerConfig(ckpt_dir=d, stop_after=3, **kw), dc,
            device="cpu").run()
    tr_b = Trainer(cfg, TrainerConfig(ckpt_dir=d, **kw), dc, device="cpu")
    assert tr_b.start_step == 3
    tr_b.run()
    for a, b in zip(tree_leaves(tr.params), tree_leaves(tr_b.params)):
        assert torch.equal(a, b)
    for a, b in zip(_port_leaves(tr.opt_state), _port_leaves(tr_b.opt_state)):
        assert torch.equal(a, b)
    # what a Trainer hands out is plain tensors, as init_params' are
    assert not any(t.requires_grad for t in tree_leaves(tr.params))
    assert [m["step"] for m in tr_b.metrics_log] == [6]


def test_preemption_checkpoints_and_exits_143(tmp_path):
    _, cfg = _llama()
    d = str(tmp_path / "pre")
    tr = Trainer(cfg, TrainerConfig(steps=50, log_every=50, ckpt_every=50,
                                    ckpt_dir=d, lr=1e-3, warmup=1),
                 DataConfig(global_batch=2, seq_len=8, seed=0), device="cpu")
    tr.preempt.request()  # as SIGTERM would, before the loop starts
    with pytest.raises(SystemExit) as e:
        tr.run()
    assert e.value.code == 143
    assert checkpoint.latest_step(d) == 1


def test_loss_decreases_on_learnable_data(tmp_path):
    _, cfg = _llama()
    tr = Trainer(cfg, TrainerConfig(steps=60, log_every=20, ckpt_every=1000,
                                    ckpt_dir=str(tmp_path / "ck"), lr=2e-3,
                                    warmup=5),
                 DataConfig(global_batch=8, seq_len=32, seed=0), device="cpu")
    tr.run()
    first, last = tr.metrics_log[0]["loss"], tr.metrics_log[-1]["loss"]
    assert last < first - 0.02, (first, last)


def test_port_trainer_resumes_a_jax_checkpoint_with_the_jax_losses(tmp_path):
    """The JAX Trainer runs 6 steps, checkpointing at 3 and 6; the port's
    Trainer resumes its step-3 checkpoint and runs to 6: the losses it
    logs at steps 4-6 are the JAX run's."""
    jc, tc = _llama()
    kw = dict(steps=6, log_every=1, ckpt_every=3, lr=1e-3, warmup=2)
    dc = dict(global_batch=4, seq_len=16, seed=0)
    jtrainer = jtr.Trainer(jc, jtr.TrainerConfig(
        ckpt_dir=str(tmp_path / "j"), **kw), jtr.DataConfig(**dc))
    jtrainer.run()
    want = {m["step"]: m["loss"] for m in jtrainer.metrics_log}
    d = tmp_path / "t"
    d.mkdir()
    shutil.copytree(tmp_path / "j" / "step_00000003", d / "step_00000003")
    tr = Trainer(tc, TrainerConfig(ckpt_dir=str(d), **kw), DataConfig(**dc),
                 device="cpu")
    assert tr.start_step == 3
    tr.run()
    got = {m["step"]: m["loss"] for m in tr.metrics_log}
    assert sorted(got) == [4, 5, 6]
    for s in got:
        assert _rel(got[s], want[s]) <= 1e-4, (s, got[s], want[s])


def test_launch_train_smoke_on_the_cpu(tmp_path):
    from repro_torch.launch.train import main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["--arch", "llama3.2-1b", "--smoke", "--steps", "4",
              "--log-every", "2", "--batch", "2", "--seq-len", "16",
              "--ckpt-dir", str(tmp_path / "ck"), "--device", "cpu"])
    lines = out.getvalue().splitlines()
    logs = [json.loads(x) for x in lines if x.startswith("{")]
    assert [m["step"] for m in logs] == [2, 4]
    assert all(np.isfinite(m["loss"]) for m in logs)
    assert lines[-1].startswith("final:")
    assert checkpoint.latest_step(str(tmp_path / "ck")) == 4


def test_training_entry_points_refuse_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    _, cfg = _llama()
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path)),
                DataConfig(global_batch=2, seq_len=8))
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--arch", "llama3.2-1b", "--smoke", "--steps", "1",
              "--ckpt-dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# the kernels refuse autograd
# ---------------------------------------------------------------------------

def test_make_loss_fn_refuses_the_cuda_kernels():
    _, cfg = _llama()
    with pytest.raises(ValueError, match="backward"):
        make_loss_fn(cfg, impl="cuda")


def test_refuse_autograd_raises_only_where_a_gradient_would_vanish():
    a = torch.zeros(2, requires_grad=True)
    b = torch.zeros(2)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_autograd("k", b, a)
    _build.refuse_autograd("k", b, b)  # nothing requires grad
    with torch.no_grad():
        _build.refuse_autograd("k", a, b)  # autograd is off
    # on the CPU the wrappers run the plain version, which differentiates
    from repro_torch.kernels import decode_attention as dk
    u = torch.randn(1, 2, 64, requires_grad=True)
    k = torch.randn(1, 4, 1, 64)
    kvp = torch.arange(4, dtype=torch.int32)[None]
    out = dk.decode_attention_merged_bsd(u, k, k, kvp,
                                         torch.tensor([3], dtype=torch.int32))
    out.sum().backward()
    assert u.grad is not None and torch.isfinite(u.grad).all()
