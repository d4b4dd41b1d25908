"""The port's chunk programs (``forward_prefill_chunk`` over the CHUNK
registry) against ``repro.models.forward_prefill_chunk``: on the same
weights (the JAX package's init and qp merge, copied by the bridge) one
13-token prompt runs as two 8-token chunks (the second padded) into slot 1
of a 2-slot dense cache, into permuted pages of a paged pool, and into
the int8 pool, for each of the 12 registered combos (dense, paged,
paged_q8 x generic, merged x the port's two impls, held against the JAX
chunk program of the matching impl).  A -1 block id drops its page's
write on both sides.

Tolerances: each chunk's last logits within 1e-5 of the reference's
largest |logit| (float32 on both sides); written float K/V rows within
1e-6 of the reference's largest |value|; int8 pages and kv positions
exact; scales rtol 1e-6.  The refusals of ``forward_prefill_chunk``
(batch, stack kind, page multiple, ring width, block_ids length, binding
dense window, unknown destination) raise like the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import models as jm
from repro.core import merge_skipless as jax_merge
from repro_torch import configs as tcfg
from repro_torch import models as tm
from repro_torch.convert import to_torch
from repro_torch.models import backends

LOGIT_TOL = 1e-5
KV_TOL = 1e-6
C, BS, MAX_LEN, TRUE_LEN, SLOT = 8, 4, 32, 13, 1
TABLE = [5, 2, 7, 0, -1, -1, -1, -1]  # the slot's pages, MB = 32 / 4
BIDS = ([5, 2], [7, -1])  # per chunk; block 3's write is dropped
IMPL_PAIRS = (("torch", "xla"), ("cuda", "pallas_interpret"))


@pytest.fixture(scope="module")
def models():
    base = dict(block_style="skipless", dtype="float32",
                param_dtype="float32", n_kv_heads=4, sliding_window=0)
    jc = jcfg.reduce_config(jcfg.get_config("mistral-7b")).with_(**base)
    tc = tcfg.reduce_config(tcfg.get_config("mistral-7b")).with_(**base)
    p = jm.init_params(jax.random.PRNGKey(0), jc)
    p["embed"]["table"] = p["embed"]["table"] * 50.0
    mp, mc = jax_merge(p, jc, "qp")
    out = {}
    for style, (c, pp) in (("generic", (jc, p)), ("merged", (mc, mp))):
        tcc = tc.with_(block_style=c.block_style,
                       merged_variant=c.merged_variant)
        out[style] = (c, pp, tcc,
                      to_torch(jax.tree.map(np.asarray, pp), device="cpu"))
    prompt = (np.arange(TRUE_LEN) * 7 + 3) % jc.vocab_size
    return out, prompt


def _chunks(prompt):
    rows = []
    for start in range(0, len(prompt), C):
        row = np.zeros((C,), np.int32)
        part = prompt[start:start + C]
        row[:len(part)] = part
        rows.append((start, row))
    return rows


def _jax_run(kind, c, p, prompt, impl):
    logits = []
    if kind == "dense":
        cache = jm.init_cache(c, 2, MAX_LEN)
    elif kind == "paged":
        pools = jm.init_paged_cache(c, 8, BS, 2, MAX_LEN)
        store = (pools.k, pools.v)
    else:
        pools = jm.init_paged_q8_cache(c, 8, BS, 2, MAX_LEN)
        store = (pools.k, pools.v, pools.k_scale, pools.v_scale)
    table = jnp.asarray([TABLE], jnp.int32)
    for i, (start, row) in enumerate(_chunks(prompt)):
        kw = dict(start=jnp.asarray([start], jnp.int32),
                  true_len=jnp.asarray([TRUE_LEN], jnp.int32), impl=impl)
        x = jnp.asarray(row)[None]
        bids = jnp.asarray(BIDS[i], jnp.int32)
        if kind == "dense":
            lg, cache = jm.forward_prefill_chunk(
                p, c, x, jm.DenseChunkDest(cache, jnp.asarray([SLOT])),
                max_len=MAX_LEN, **kw)
        elif kind == "paged":
            lg, store = jm.forward_prefill_chunk(
                p, c, x, jm.PagedChunkDest(*store, table, bids), **kw)
        else:
            lg, store = jm.forward_prefill_chunk(
                p, c, x, jm.PagedQ8ChunkDest(*store, table, bids), **kw)
        logits.append(np.asarray(lg))
    if kind == "dense":
        store = (cache.k, cache.v, cache.kv_pos, cache.length)
    return logits, [np.asarray(t) for t in store]


def _port_run(kind, c, p, prompt, impl):
    logits = []
    if kind == "dense":
        cache = tm.init_cache(c, 2, MAX_LEN, device="cpu")
    elif kind == "paged":
        pools = tm.init_paged_cache(c, 8, BS, 2, MAX_LEN, device="cpu")
        store = (pools.k, pools.v)
    else:
        pools = tm.init_paged_q8_cache(c, 8, BS, 2, MAX_LEN, device="cpu")
        store = (pools.k, pools.v, pools.k_scale, pools.v_scale)
    table = torch.tensor([TABLE], dtype=torch.int32)
    for i, (start, row) in enumerate(_chunks(prompt)):
        x = torch.from_numpy(row)[None]
        bids = torch.tensor(BIDS[i], dtype=torch.int32)
        kw = dict(start=start, true_len=TRUE_LEN, impl=impl)
        if kind == "dense":
            lg, cache = tm.forward_prefill_chunk(
                p, c, x, tm.DenseChunkDest(cache, SLOT), max_len=MAX_LEN,
                **kw)
        elif kind == "paged":
            lg, store = tm.forward_prefill_chunk(
                p, c, x, tm.PagedChunkDest(*store, table, bids), **kw)
        else:
            lg, store = tm.forward_prefill_chunk(
                p, c, x, tm.PagedQ8ChunkDest(*store, table, bids), **kw)
        logits.append(lg.numpy())
    if kind == "dense":
        store = (cache.k, cache.v, cache.kv_pos, cache.length)
    return logits, [t.numpy() for t in store]


@pytest.mark.parametrize("impls", IMPL_PAIRS, ids=lambda p: p[0])
@pytest.mark.parametrize("style", ["generic", "merged"])
@pytest.mark.parametrize("kind", ["dense", "paged", "paged_q8"])
def test_chunk_program_matches_the_jax_chunk_program(models, kind, style,
                                                     impls):
    mods, prompt = models
    jc, jp, tc, tp = mods[style]
    impl, jimpl = impls
    assert backends.get_chunk_backend(kind, style, impl).fast_path == \
        (style == "merged")
    want_lg, want = _jax_run(kind, jc, jp, prompt, jimpl)
    got_lg, got = _port_run(kind, tc, tp, prompt, impl)
    for g, w in zip(got_lg, want_lg):
        assert g.shape == w.shape == (1, jc.vocab_size)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=LOGIT_TOL * np.abs(w).max())
    if kind == "dense":
        for g, w in zip(got[:2], want[:2]):  # K/V, all rows of both slots
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=KV_TOL * np.abs(w).max())
        np.testing.assert_array_equal(got[2], want[2])  # kv_pos
        np.testing.assert_array_equal(got[3], want[3])  # length
        assert got[3][SLOT] == TRUE_LEN and got[3][1 - SLOT] == 0
    elif kind == "paged":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=KV_TOL * np.abs(w).max())
        assert not got[0][:, 0].any(), "the -1 block id wrote its page"
    else:
        np.testing.assert_array_equal(got[0], want[0])  # int8 pages
        np.testing.assert_array_equal(got[1], want[1])
        for g, w in zip(got[2:], want[2:]):  # scales
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        assert not got[0][:, 0].any() and not got[2][:, 0].any()


def test_chunk_registry_has_the_references_combos():
    combos = backends.registered_chunk_backends()
    assert combos == sorted((k, s, i) for k in ("dense", "paged", "paged_q8")
                            for s in ("generic", "merged")
                            for i in ("cuda", "torch"))
    with pytest.raises(KeyError, match="registered chunk combos"):
        backends.get_chunk_backend("dense", "generic", "xla")


def test_forward_prefill_chunk_refusals(models):
    mods, _ = models
    _, _, tc, tp = mods["generic"]
    x = torch.zeros((1, C), dtype=torch.long)
    cache = tm.init_cache(tc, 2, MAX_LEN, device="cpu")
    pools = tm.init_paged_cache(tc, 8, BS, 2, MAX_LEN, device="cpu")
    table = torch.tensor([TABLE], dtype=torch.int32)
    bids = torch.tensor([5, 2], dtype=torch.int32)
    kw = dict(start=0, true_len=C)
    with pytest.raises(ValueError, match="one stream"):
        tm.forward_prefill_chunk(tp, tc, torch.zeros((2, C), dtype=torch.long),
                                 tm.DenseChunkDest(cache, 0), **kw)
    with pytest.raises(ValueError, match="multiple of the page size"):
        tm.forward_prefill_chunk(tp, tc, x[:, :6], tm.PagedChunkDest(
            pools.k, pools.v, table, bids[:1]), **kw)
    with pytest.raises(ValueError, match="block_ids maps 1 blocks"):
        tm.forward_prefill_chunk(tp, tc, x, tm.PagedChunkDest(
            pools.k, pools.v, table, bids[:1]), **kw)
    wc = tc.with_(sliding_window=3)  # a ring of 2 slots of 4
    ring = tm.init_paged_cache(wc, 8, BS, 2, MAX_LEN, device="cpu")
    assert ring.block_tables.shape[1] < MAX_LEN // BS
    with pytest.raises(ValueError, match="exactly one block"):
        tm.forward_prefill_chunk(tp, wc, x, tm.PagedChunkDest(
            ring.k, ring.v, ring.block_tables[:1], bids), **kw)
    with pytest.raises(ValueError, match="dense sliding-window"):
        tm.forward_prefill_chunk(tp, wc, x, tm.DenseChunkDest(cache, 0),
                                 max_len=MAX_LEN, **kw)
    with pytest.raises(ValueError, match="unknown chunk destination"):
        tm.forward_prefill_chunk(tp, tc, x, tm.DensePrefillDest(MAX_LEN),
                                 **kw)
    with pytest.raises(KeyError, match="ChunkBackend"):
        tm.forward_prefill_chunk(tp, tc, x, tm.DenseChunkDest(cache, 0),
                                 impl="xla", **kw)
    ssm = tcfg.reduce_config(tcfg.get_config("hymba-1.5b"))
    with pytest.raises(ValueError, match="attention-only"):
        tm.forward_prefill_chunk(tp, ssm, x, tm.DenseChunkDest(cache, 0),
                                 **kw)
