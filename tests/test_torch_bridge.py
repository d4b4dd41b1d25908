"""The weight bridge (``repro_torch.convert``) and the port's copy of the
configs, held against the JAX package."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import init_params as jax_init_params
from repro_torch import configs as tcfg
from repro_torch.convert import from_torch, to_torch


@pytest.fixture(scope="module")
def jax_trees():
    """Every registered arch at reduce_config size, initialised by the JAX
    package and brought to the host as numpy (plus one bf16 tree)."""
    out = {}
    for arch in jcfg.list_archs():
        cfg = jcfg.reduce_config(jcfg.get_config(arch))
        out[arch] = jax.tree.map(np.asarray,
                                 jax_init_params(jax.random.PRNGKey(0), cfg))
    cfg = jcfg.reduce_config(jcfg.get_config("mistral-7b"),
                             param_dtype="bfloat16")
    out["mistral-7b-bf16"] = jax.tree.map(
        np.asarray, jax_init_params(jax.random.PRNGKey(1), cfg))
    return out


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def test_round_trip_is_exact_for_every_family(jax_trees):
    for arch, tree in jax_trees.items():
        t = to_torch(tree, device="cpu")
        back = from_torch(t)
        a, b = _leaves(tree), _leaves(back)
        assert [p for p, _ in a] == [p for p, _ in b], arch
        for (path, x), (_, y) in zip(a, b):
            assert x.shape == y.shape, (arch, path)
            np.testing.assert_array_equal(
                np.asarray(x, np.float64) if x.dtype.kind == "V" or
                x.dtype.name == "bfloat16" else x, y, err_msg=f"{arch}{path}")


def test_bf16_leaves_stay_bf16_in_torch(jax_trees):
    tree = jax_trees["mistral-7b-bf16"]
    t = to_torch(tree, device="cpu")
    assert t["layers"]["ffn"]["w_up"].dtype == torch.bfloat16
    want = np.asarray(tree["layers"]["ffn"]["w_up"], np.float32)
    np.testing.assert_array_equal(t["layers"]["ffn"]["w_up"].float().numpy(),
                                  want)
    # back as float32: the widening of the JAX leaf, exactly
    back = from_torch(t)["layers"]["ffn"]["w_up"]
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, want)


def test_the_bridge_copies_both_ways(jax_trees):
    tree = {"w": np.array(jax_trees["mistral-7b"]["embed"]["table"])}
    t = to_torch(tree, device="cpu")
    tree["w"][0, 0] += 1.0
    assert t["w"][0, 0].item() != tree["w"][0, 0]
    back = from_torch(t)
    t["w"][0, 1] += 1.0
    assert back["w"][0, 1] != t["w"][0, 1].item()


@pytest.mark.parametrize("reduced", [False, True])
def test_port_config_copy_matches_the_reference(reduced):
    j = jcfg.get_config("mistral-7b")
    t = tcfg.get_config("mistral-7b")
    if reduced:
        j, t = jcfg.reduce_config(j), tcfg.reduce_config(t)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (j.padded_vocab, j.attn_dim, j.kv_dim) == \
        (t.padded_vocab, t.attn_dim, t.kv_dim)
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get_config("no-such-arch")
