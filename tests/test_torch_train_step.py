"""The port's train step (``repro_torch.training.make_loss_fn`` /
``make_train_step``, ``forward_seq(remat=...)``) held against
``repro.training`` on the same weights: the JAX package initialises each
reduced model, the bridge copies the weights, and both sides take the
same numpy-seeded batch.

Tolerances (float32 on both sides unless said, the products summed in
another order):
  * gradients of one step, every arch x every block style
    ``validate_style`` admits: each leaf within 1e-4 of the reference
    leaf's largest |grad| (measured at most 1.3e-5); the loss 1e-6
    relative.  A leaf the loss does not reach has a ``None`` gradient in
    the port where JAX has exact zeros (HuBERT's token embedding, a
    parallel block's ``norm2``);
  * ``grad_accum=2``: the averaged gradients that reach the optimizer
    (an optimizer that returns its gradients as the new params, the same
    on both sides) within 1e-4 of each leaf's largest |grad|, the mean
    loss 1e-6 relative;
  * bfloat16 compute over float32 params: the loss 1e-2 relative;
  * remat False / True / "dots" in the port: losses and gradients equal
    (the recomputation runs the same operations on the same inputs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jcfg
from repro import models as jm
from repro.training import make_train_step as j_make_train_step
from repro_torch import configs as tcfg
from repro_torch._tree import tree_map
from repro_torch.convert import to_torch
from repro_torch.models import forward_seq, init_params
from repro_torch.training import make_loss_fn, make_train_step

STYLES = ("standard", "skipless", "skipless_merged", "residual_qpfree")
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-6


def _valid(arch, style):
    try:
        tcfg.get_config(arch).with_(block_style=style).validate_style()
    except ValueError:
        return False
    return True


COMBOS = [(a, s) for a in tcfg.list_archs() for s in STYLES if _valid(a, s)]


def _cfgs(arch, style="standard", **kw):
    return (jcfg.reduce_config(jcfg.get_config(arch), block_style=style,
                               **kw),
            tcfg.reduce_config(tcfg.get_config(arch), block_style=style,
                               **kw))


def _batch(cfg, B=2, S=8, seed=0):
    """numpy inputs, labels and (a VLM's) vision tokens."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        x = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    b = {"inputs": x,
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["vision"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return b


def _jax_params(jc):
    return jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0), jc))


def _jax_value_and_grad(jc, params, batch):
    def f(p):
        lg, aux, _ = jm.forward_seq(p, jc, jnp.asarray(batch["inputs"]),
                                    vision=None if "vision" not in batch
                                    else jnp.asarray(batch["vision"]))
        return jm.lm_loss(lg, jnp.asarray(batch["labels"]),
                          vocab_size=jc.vocab_size) + 1e-2 * aux
    loss, grads = jax.jit(jax.value_and_grad(f))(
        jax.tree.map(jnp.asarray, params))
    return float(loss), jax.tree.map(np.asarray, grads)


def _torch_value_and_grad(tc, params, batch, remat=False):
    live = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, metrics = make_loss_fn(tc, remat=remat)(live, tb)
    total.backward()
    return float(total.detach()), tree_map(lambda p: p.grad, live), metrics


def _close_grads(got, want, msg=""):
    """Each leaf within GRAD_RTOL of the reference leaf's largest |grad|;
    a ``None`` leaf only where the reference's is exactly zero."""
    if isinstance(want, dict):
        assert set(got) == set(want), msg
        for k in want:
            _close_grads(got[k], want[k], f"{msg}/{k}")
        return
    if got is None:
        assert not np.any(want), f"{msg}: no gradient where JAX has one"
        return
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.numpy() - want).max()) / scale
    assert err <= GRAD_RTOL, f"{msg}: {err:.2e} of the leaf's max |grad|"


@pytest.fixture(scope="module")
def one_step():
    """(arch, style) -> (params, batch, JAX loss and grads, the port's
    loss and grads), each computed once per module."""
    cache = {}

    def get(arch, style):
        if (arch, style) not in cache:
            jc, tc = _cfgs(arch, style)
            params = _jax_params(jc)
            batch = _batch(tc)
            want = _jax_value_and_grad(jc, params, batch)
            got = _torch_value_and_grad(tc, to_torch(params, device="cpu"),
                                        batch)[:2]
            cache[arch, style] = want, got
        return cache[arch, style]
    return get


@pytest.mark.parametrize("arch,style", COMBOS)
def test_one_step_gradients_match_jax(one_step, arch, style):
    (want_loss, want), (got_loss, got) = one_step(arch, style)
    assert abs(got_loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    _close_grads(got, want, f"{arch} {style}")


@pytest.mark.parametrize("arch,style,leaf", [
    ("hubert-xlarge", "standard", ("embed", "table")),
    ("pythia-6.9b", "standard", ("layers", "norm2", "scale"))])
def test_unreached_leaves_have_no_gradient_and_jax_zeros(one_step, arch,
                                                         style, leaf):
    """The two leaves the loss does not reach: frames bypass HuBERT's
    embedding, parallel blocks do not use norm2."""
    (_, want), (_, got) = one_step(arch, style)
    for k in leaf:
        want, got = want[k], got[k]
    assert got is None and want.shape and not np.any(want)


class _GradsOut:
    """An optimizer whose update returns the gradients as the new params:
    what reaches the optimizer, on either side."""

    def init(self, params):
        return ()

    def update(self, grads, state, params):
        return grads, state


GRAD_ACCUM_ARCHS = ("mistral-7b", "phi3.5-moe-42b-a6.6b", "hymba-1.5b",
                    "llama3.2-vision-11b")


@pytest.mark.parametrize("arch", GRAD_ACCUM_ARCHS)
def test_grad_accum_matches_jax(arch):
    jc, tc = _cfgs(arch)
    params = _jax_params(jc)
    batch = _batch(tc, B=4)
    opt = _GradsOut()
    jstep = jax.jit(j_make_train_step(jc, opt, grad_accum=2, remat=False))
    want, _, jm_ = jstep(jax.tree.map(jnp.asarray, params), (),
                         jax.tree.map(jnp.asarray, batch))
    got, _, tm_ = make_train_step(tc, opt, grad_accum=2, remat=False)(
        to_torch(params, device="cpu"), (),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "aux_loss"):
        assert abs(float(tm_[k]) - float(jm_[k])) <= \
            LOSS_RTOL * max(abs(float(jm_[k])), 1e-30), k
    _close_grads(got, jax.tree.map(np.asarray, want), arch)


@pytest.mark.parametrize("arch", ("mistral-7b", "llama3.2-1b"))
def test_bf16_compute_loss_matches_jax(arch):
    """bfloat16 activations over float32 params on both sides."""
    jc, tc = _cfgs(arch, dtype="bfloat16")
    params = _jax_params(jc)
    batch = _batch(tc, B=2, S=16)
    want, _ = _jax_value_and_grad(jc, params, batch)
    got, grads, _ = _torch_value_and_grad(
        tc, to_torch(params, device="cpu"), batch)
    assert abs(got - want) <= 1e-2 * abs(want), (got, want)
    # the gradients come back through the casts, in the params' float32
    assert all(g.dtype == torch.float32
               for g in grads["layers"]["attn"].values())


REMAT_ARCHS = ("mistral-7b", "moonshot-v1-16b-a3b", "hymba-1.5b",
               "mamba2-2.7b", "llama3.2-vision-11b", "hubert-xlarge")


@pytest.mark.parametrize("remat", (True, "dots"))
@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_gives_the_same_loss_and_gradients(arch, remat):
    _, tc = _cfgs(arch, "skipless" if arch == "mamba2-2.7b"
                  else "residual_qpfree")
    params = init_params(tc, seed=0, device="cpu")
    batch = _batch(tc)
    want_loss, want, _ = _torch_value_and_grad(tc, params, batch, False)
    got_loss, got, _ = _torch_value_and_grad(tc, params, batch, remat)
    assert got_loss == want_loss

    def same(a, b):
        assert (a is None and b is None) or torch.equal(a, b)
    tree_map(same, got, want)


class _CountMM(TorchDispatchMode):
    """Counts the matmuls dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                    torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_remat_recomputes_matmuls_and_dots_keeps_them():
    """remat=True runs each block's forward matmuls again in the
    backward; "dots" saves their outputs, so its backward runs exactly
    the matmuls of no remat."""
    _, tc = _cfgs("mistral-7b")
    params = init_params(tc, seed=0, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(tc).items()}
    counts = {}
    for remat in (False, True, "dots"):
        live = tree_map(lambda p: p.detach().clone().requires_grad_(),
                        params)
        total, _ = make_loss_fn(tc, remat=remat)(live, tb)
        with _CountMM() as c:
            total.backward()
        counts[remat] = c.n
    assert counts["dots"] == counts[False] < counts[True], counts


def test_remat_with_collect_raises():
    _, tc = _cfgs("mistral-7b")
    params = init_params(tc, device="cpu")
    x = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="collect"):
        forward_seq(params, tc, x, collect_kv=True, remat=True)
    with pytest.raises(ValueError, match="remat"):
        forward_seq(params, tc, x, remat="all")
