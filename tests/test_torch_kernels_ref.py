"""The plain versions of the four dense attention kernels, the wrappers
that run them for CPU tensors, the model-layout ops and the attention
cores — held against the JAX package on the same numpy-seeded inputs:
the Pallas kernels in interpret mode (``repro.kernels.ops``), their jnp
oracles (``repro.kernels.ref``) and the XLA cores
(``repro.models.attention``).  float32, atol 1e-5.

Covered: G = Hq/Hkv in {1, 2, 4}, sliding windows, ragged (prime) Sq,
-1 empty slots, ring-phased positions past the cache length, and a
decode row with nothing to attend to (exactly zero)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

ATOL = 1e-5
D, Hkv, S_CACHE = 16, 2, 24
GROUPS = (1, 2, 4)
SQS = (5, 19)
WINDOWS = (0, 4)
Q_POS = (3, 23, 61)  # a short row, a full cache, a wrapped ring


def _ring_positions(rng, S, q_pos):
    s = np.arange(S)[None, :]
    qp = np.asarray(q_pos)[:, None]
    pos = np.where(s <= qp, s + S * ((qp - s) // S), -1)
    pos = np.where(rng.random(pos.shape) < 0.15, -1, pos)
    pos[0] = -1  # row 0 (q_pos 3) has nothing to attend to:
    pos[0, 5] = 5  # its only filled slot lies in its future
    return pos.astype(np.int32)


@pytest.fixture(scope="module")
def cases():
    """Inputs and JAX outputs for every flash, decode and sequence-core
    case."""
    rng = np.random.default_rng(0)
    flash, decode = {}, {}
    for G in GROUPS:
        Hq = Hkv * G
        for Sq in SQS:
            u = rng.standard_normal((2, Sq, Hq, D)).astype(np.float32)
            k = rng.standard_normal((2, Sq, Hkv, D)).astype(np.float32)
            v = rng.standard_normal((2, Sq, Hkv, D)).astype(np.float32)
            for w in WINDOWS:
                ju, jk, jv = map(jnp.asarray, (u, k, v))
                flash[(G, Sq, w)] = dict(
                    u=u, k=k, v=v,
                    kernel=np.asarray(jops.flash_attention(
                        ju, jk, jv, sliding_window=w, interpret=True)),
                    oracle=np.asarray(jref.ref_attention(
                        ju.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
                        jv.transpose(0, 2, 1, 3), sliding_window=w)))
        B = len(Q_POS)
        u = rng.standard_normal((B, Hq, D)).astype(np.float32)
        k = rng.standard_normal((B, S_CACHE, Hkv, D)).astype(np.float32)
        v = rng.standard_normal((B, S_CACHE, Hkv, D)).astype(np.float32)
        kvp = _ring_positions(rng, S_CACHE, Q_POS)
        qp = np.asarray(Q_POS, np.int32)
        for w in (0, 5):
            ju, jk, jv, jkvp, jqp = map(jnp.asarray, (u, k, v, kvp, qp))
            decode[(G, w)] = dict(
                u=u, k=k, v=v, kvp=kvp, qp=qp,
                kernel=np.asarray(jops.decode_attention(
                    ju, jk, jv, kv_positions=jkvp, q_position=jqp,
                    sliding_window=w, interpret=True)),
                merged=np.asarray(jops.decode_attention_merged(
                    ju.reshape(B, Hq * D), jk, jv, kv_positions=jkvp,
                    q_position=jqp, n_kv_heads=Hkv, sliding_window=w,
                    interpret=True)),
                oracle=np.asarray(jref.ref_decode_attention(
                    ju.reshape(B, Hkv, G, D), jk.transpose(0, 2, 1, 3),
                    jv.transpose(0, 2, 1, 3), jkvp, jqp[:, None],
                    sliding_window=w)),
                core=np.asarray(jattn.decode_attention_core_positions(
                    ju, jk, jv, kv_positions=jkvp, q_position=jqp,
                    sliding_window=w)))
    seq = {}
    for G in GROUPS:
        r = np.random.default_rng(G)
        Sq, Hq = 20, Hkv * G
        q = r.standard_normal((2, Sq, Hq, D)).astype(np.float32)
        k = r.standard_normal((2, Sq, Hkv, D)).astype(np.float32)
        v = r.standard_normal((2, Sq, Hkv, D)).astype(np.float32)
        pos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (2, Sq))
        for chunk in (1024, 4):
            seq[(G, chunk)] = dict(q=q, k=k, v=v, pos=pos, out=np.asarray(
                jattn.attention_core(
                    *map(jnp.asarray, (q, k, v)),
                    q_positions=jnp.asarray(pos),
                    kv_positions=jnp.asarray(pos), sliding_window=6,
                    query_chunk=chunk)))
    return flash, decode, seq


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("Sq", SQS)
@pytest.mark.parametrize("w", WINDOWS)
def test_flash_plain_versions_and_wrappers_match(cases, G, Sq, w):
    c = cases[0][(G, Sq, w)]
    u, k, v = _t(c["u"]), _t(c["k"]), _t(c["v"])
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (u, k, v))
    # the plain versions against the jnp oracle and the Pallas kernel
    _close(tref.ref_attention(qh, kh, vh, sliding_window=w), c["oracle"])
    _close(tref.ref_flash_attention_merged(u, k, v, sliding_window=w),
           c["kernel"])
    # the kernel wrappers on CPU tensors, and the model-layout ops
    _close(fk.flash_attention_bhsd(qh, kh, vh, sliding_window=w)
           .transpose(1, 2), c["kernel"])
    _close(fk.flash_attention_merged_bsd(u, k, v, sliding_window=w),
           c["kernel"])
    _close(tops.flash_attention(u, k, v, sliding_window=w), c["kernel"])
    _close(tops.flash_attention_merged(u.reshape(2, Sq, -1), k, v,
                                       n_kv_heads=Hkv, sliding_window=w),
           c["kernel"].reshape(2, Sq, -1))


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("w", (0, 5))
def test_decode_plain_versions_and_wrappers_match(cases, G, w):
    c = cases[1][(G, w)]
    u, k, v, kvp, qp = (_t(c[n]) for n in ("u", "k", "v", "kvp", "qp"))
    B = u.shape[0]
    kh, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    qg = u.reshape(B, Hkv, G, D)
    _close(tref.ref_decode_attention(qg, kh, vh, kvp, qp, sliding_window=w),
           c["oracle"])
    _close(tref.ref_decode_attention_merged(u, k, v, kvp, qp,
                                            sliding_window=w), c["kernel"])
    _close(dk.decode_attention_bhsd(qg, kh, vh, kvp, qp, sliding_window=w)
           .reshape(B, -1, D), c["kernel"])
    got = dk.decode_attention_merged_bsd(u, k, v, kvp, qp, sliding_window=w)
    _close(got, c["kernel"])
    _close(tops.decode_attention(u, k, v, kv_positions=kvp, q_position=qp,
                                 sliding_window=w), c["kernel"])
    _close(tops.decode_attention_merged(
        u.reshape(B, -1), k, v, kv_positions=kvp, q_position=qp,
        n_kv_heads=Hkv, sliding_window=w), c["merged"])


def test_decode_row_with_nothing_to_attend_is_exactly_zero(cases):
    c = cases[1][(2, 5)]
    out = dk.decode_attention_merged_bsd(*(_t(c[n]) for n in
                                           ("u", "k", "v", "kvp", "qp")),
                                         sliding_window=5)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert np.array_equal(c["kernel"][0], np.zeros_like(c["kernel"][0]))


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("w", (0, 5))
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_decode_cores_match_the_xla_cores(cases, G, w, impl):
    """impl="torch" is the port of the XLA core; impl="cuda" routes to the
    kernel wrappers, which run the plain versions on CPU tensors (the two
    agree wherever a row has something to attend to)."""
    c = cases[1][(G, w)]
    u, k, v, kvp, qp = (_t(c[n]) for n in ("u", "k", "v", "kvp", "qp"))
    B = u.shape[0]
    want = c["core"] if impl == "torch" else c["kernel"]
    got = tattn.decode_attention_core_positions(
        u, k, v, kv_positions=kvp, q_position=qp, sliding_window=w,
        impl=impl)
    _close(got[1:], want[1:])
    got = tattn.decode_attention_core_merged(
        u.reshape(B, -1), k, v, kv_positions=kvp, q_position=qp,
        n_kv_heads=Hkv, sliding_window=w, impl=impl)
    _close(got[1:], want.reshape(B, -1)[1:])


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("chunk", [1024, 4])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_sequence_cores_match_the_xla_cores(cases, G, chunk, impl):
    """Sq=20 so a query_chunk of 4 runs the chunked branch."""
    c = cases[2][(G, chunk)]
    q, k, v, pos = (_t(c[n]) for n in ("q", "k", "v", "pos"))
    B, Sq = q.shape[0], q.shape[1]
    got = tattn.attention_core(q, k, v, q_positions=pos, kv_positions=pos,
                               sliding_window=6, query_chunk=chunk,
                               impl=impl)
    _close(got, c["out"])
    got = tattn.attention_core_merged(
        q.reshape(B, Sq, -1), k, v, q_positions=pos, kv_positions=pos,
        n_kv_heads=Hkv, sliding_window=6, query_chunk=chunk, impl=impl)
    _close(got, c["out"].reshape(B, Sq, -1))


def test_kernel_table_and_unknown_combos():
    assert set(tops.ATTENTION_KERNELS) == {
        (ph, "dense", st) for ph in ("prefill", "decode")
        for st in ("generic", "merged")}
    assert tops.decode_kernel("dense", "merged") is tops.decode_attention_merged
    with pytest.raises(KeyError, match="available"):
        tops.attention_kernel("decode", "paged", "merged")
    with pytest.raises(KeyError, match="available"):
        tops.decode_kernel("paged_q8", "generic")
    with pytest.raises(ValueError, match="kv_valid"):
        tops.flash_attention(torch.zeros(1, 2, 2, 16), torch.zeros(1, 2, 1, 16),
                             torch.zeros(1, 2, 1, 16),
                             kv_valid=torch.ones(1, 2, dtype=torch.bool))
    with pytest.raises(ValueError, match="impl"):
        tattn.decode_attention_core_positions(
            torch.zeros(1, 2, 16), torch.zeros(1, 4, 1, 16),
            torch.zeros(1, 4, 1, 16), kv_positions=torch.zeros(1, 4),
            q_position=torch.tensor([1]), impl="xla")
