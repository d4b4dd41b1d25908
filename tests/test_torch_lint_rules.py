"""repro_torch.lint's graph side: every rule proven LIVE (it fires on a
bad program and stays quiet on a good one), the registry's behaviour, the
sweep proven COMPLETE (36 targets, one per registered combo, CLEAN on the
CPU), kernel calls as single graph nodes, the paged decode step free of
host syncs, and the matmul delta held against the reference's jaxprs.

Held against JAX: the reference's walker names ``jax.core.Jaxpr``, which
this JAX no longer has, so its sweep cannot run here; the test counts the
reference's ``dot_general`` equations with a recursion of its own over
``jax.extend.core`` (scan bodies included), on the reference's own sweep
programs (``repro.lint.sweep``'s builders, lowering switched off).  The
reference scans the layers (one body: a delta of 2); the port's graph
unrolls them (a delta of 2 per attention layer).  Counts are exact: no
tolerance.
"""
import contextlib
import importlib

import jax
import jax.extend.core as jex
import pytest
import torch

import repro.lint as jax_lint
from repro_torch import obs
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ssd_scan as sk
from repro_torch.kernels import _build, ref
from repro_torch.lint import (DonationEffective, Finding, LintRule,
                              LintTarget, NoDequantizedPoolBuffer,
                              NoDtypePromotionDrift, NoForbiddenMatmul,
                              NoHostTransferInObsHooks,
                              NoHostTransferInStepLoop, NoOversizedBuffer,
                              get_rule, register_rule, registered_rules,
                              run_rules, sweep, walker)
from repro_torch.models import backends, forward_step
from repro_torch.models.transformer import PagedQ8DecodeCache

SW = importlib.import_module("repro_torch.lint.sweep")
MAX_LEN = 160  # collides with no reduced model dim (cf. the sweep)


def _target(**kw):
    base = dict(phase="decode", cache_kind="dense", style="generic",
                impl="torch", graph=None)
    base.update(kw)
    return LintTarget(**base)


def _z(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


# ---------------------------------------------------------------------------
# walker
# ---------------------------------------------------------------------------

def test_walker_counts_ops_values_and_decomposed_matmuls():
    w = _z(3, 3)

    def f(x):
        y = torch.nn.functional.linear(x, w)       # -> mm / addmm
        z = torch.einsum("ij,jk->ik", y, w)        # -> bmm
        return torch.matmul(z, w).sum()            # -> mm

    g = walker.trace(f, _z(5, 3))
    assert walker.count_matmuls(g) == 3
    assert set(walker.op_names(g)) & walker.MATMUL_OPS
    assert any(tuple(v.shape) == (5, 3) for v in walker.iter_values(g))
    assert walker.values_with_dim(_id_graph(7), 7)
    assert walker.count_op(g, "aten.sum") == 1


def _id_graph(n):
    return walker.trace(lambda x: x * 2, _z(n))


def test_walker_finds_the_host_sync_set():
    def f(x):
        a = torch.nonzero(x > 0)
        b = x[x > 0]                       # a hidden nonzero
        c = float(x.sum())                 # .item()
        return a.sum() + b.sum() + c

    names = walker.host_sync_nodes(walker.trace(f, torch.arange(4.0)))
    assert "aten.nonzero" in names and "aten._local_scalar_dense" in names
    assert any(n.endswith("(bool mask)") for n in names)
    assert walker.host_sync_nodes(_id_graph(4)) == []
    # a blocking copy between the host and another device (the meta
    # device stands in for the card here); a non-blocking one to it
    # waits for nothing
    g = walker.trace(lambda x: (x.to("meta"), x.to("meta", non_blocking=True)),
                     torch.ones(2))
    assert walker.host_sync_nodes(g) == ["aten._to_copy(cpu to meta)"]


def test_each_kernel_call_is_one_opaque_node():
    """A wrapper's kernel operator is ONE ``repro_torch`` node on the CPU
    too (its plain version runs inside it, invisible to the graph); the
    layout plumbing around it stays aten ops."""
    u, k = torch.randn(2, 4, 64), torch.randn(2, 8, 2, 64)
    kvp = torch.arange(8, dtype=torch.int32).expand(2, 8).contiguous()
    qp = torch.tensor([7, 3], dtype=torch.int32)
    g = walker.trace(lambda *a: dk.decode_attention_merged_bsd(*a), u, k, k,
                     kvp, qp)
    nodes = walker.kernel_nodes(g)
    assert [walker.op_name(n) for n in nodes] == [
        "repro_torch.decode_attention_merged_bsd"]
    assert walker.count_matmuls(g) == 0  # the plain body is not in it
    assert "aten.softmax" not in walker.op_names(g)


def _op_cases():
    """(name, operator, CPU args, kwargs) of every kernel operator at
    small shapes."""
    r = torch.Generator().manual_seed(0)

    def rn(*s, dtype=torch.float32):
        return torch.randn(*s, generator=r).to(dtype)

    B, S, Hkv, G, D, NB, bs = 2, 8, 2, 2, 64, 6, 4
    kvp = torch.arange(S, dtype=torch.int32).expand(B, S).contiguous()
    qp = torch.tensor([7, 3], dtype=torch.int32)
    tbl = torch.tensor([[0, 1], [2, -1]], dtype=torch.int32)
    pool = rn(NB, bs, Hkv, D)
    p8 = (rn(NB, bs, Hkv, D) * 20).to(torch.int8)
    sc = rn(NB, Hkv).abs() + 0.01
    k8, s8 = (rn(B, S, Hkv, D) * 20).to(torch.int8), rn(B, 2, Hkv).abs()
    qg, qm = rn(B, Hkv, G, D), rn(B, Hkv * G, D)
    ops = torch.ops.repro_torch
    cases = [
        ("decode_attention_bhsd", (qg, rn(B, Hkv, S, D), rn(B, Hkv, S, D),
                                   kvp, qp), {"sliding_window": 4}),
        ("decode_attention_bshd", (qg, rn(B, S, Hkv, D), rn(B, S, Hkv, D),
                                   kvp, qp), {}),
        ("decode_attention_merged_bsd", (qm, rn(B, S, Hkv, D),
                                         rn(B, S, Hkv, D), kvp, qp), {}),
        ("decode_attention_paged_bhsd", (qg, pool, pool, tbl, qp), {}),
        ("decode_attention_paged_merged_bsd", (qm, pool, pool, tbl, qp),
         {}),
        ("decode_attention_paged_q8_bhsd", (qg, p8, p8, sc, sc, tbl, qp),
         {}),
        ("decode_attention_paged_q8_merged_bsd", (qm, p8, p8, sc, sc, tbl,
                                                  qp), {}),
        ("flash_attention_bhsd", (rn(B, 4, S, D), rn(B, Hkv, S, D),
                                  rn(B, Hkv, S, D)), {"causal": True}),
        ("flash_attention_bshd", (rn(B, S, 4, D), rn(B, S, Hkv, D),
                                  rn(B, S, Hkv, D)), {"sliding_window": 3}),
        ("flash_attention_merged_bsd", (rn(B, S, 4, D), rn(B, S, Hkv, D),
                                        rn(B, S, Hkv, D)), {}),
        ("flash_attention_merged_q8_bsd", (rn(B, S, 4, D), k8, k8, s8, s8),
         {}),
        ("ssd_chunk_scan", (rn(1, S, 2, 16), rn(1, S, 2).abs(),
                            -rn(1, S, 2).abs(), rn(1, S, 2, 8),
                            rn(1, S, 2, 8)), {"chunk": 4}),
    ]
    # each decode operator's partial-state twin takes its operands (the
    # in-place bshd launch has none)
    return cases + [(n + "_states", a, kw) for n, a, kw in cases
                    if n.startswith("decode")
                    and n != "decode_attention_bshd"], ops


def test_every_kernel_operator_is_registered_with_a_fake():
    """Each of the eighteen entry points (the twelve kernels' and the six
    decode partial-state twins) is ``torch.ops.repro_torch.<name>``;
    on CPU tensors it runs the plain version, and its fake implementation
    gives the real output's shapes and dtypes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cases, ops = _op_cases()
    assert sorted(n for n, _, _ in cases) == sorted(_build.OPS)
    for name, args, kw in cases:
        op = getattr(ops, name)
        real = op(*args, **kw)
        with FakeTensorMode() as mode:
            fake = op(*[mode.from_tensor(a) for a in args], **kw)
        real, fake = (real, fake) if isinstance(real, tuple) \
            else ((real,), (fake,))
        assert [(tuple(t.shape), t.dtype) for t in real] == \
            [(tuple(t.shape), t.dtype) for t in fake], name
        assert all(torch.isfinite(t).all() for t in real), name


def test_kernel_operators_are_functional_and_match_the_plain_versions():
    cases, ops = _op_cases()
    for name, args, kw in cases:
        before = [a.clone() for a in args]
        out = getattr(ops, name)(*args, **kw)
        assert all(torch.equal(a, b) for a, b in zip(args, before)), name
        for t in (out if isinstance(out, tuple) else (out,)):
            assert all(t.untyped_storage().data_ptr()
                       != a.untyped_storage().data_ptr() for a in args)
    q, k, v, kvp, qp = cases[2][1]
    assert torch.equal(ops.decode_attention_merged_bsd(q, k, v, kvp, qp),
                       ref.ref_decode_attention_merged(q, k, v, kvp, qp))


def test_operators_differentiate_through_the_plain_version_on_the_cpu():
    """On CPU tensors autograd differentiates an operator as it does its
    plain version (the CUDA operands that require grad are refused in
    front of the operator, on the card)."""
    g = torch.Generator().manual_seed(1)
    u, k, v = (torch.randn(1, 8, 4, 64, generator=g) for _ in range(3))
    grads = []
    for fn in (fk.flash_attention_merged_bsd, ref.ref_flash_attention_merged):
        leaves = [t.clone().requires_grad_() for t in (u, k, v)]
        (fn(*leaves, sliding_window=3) ** 2).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.allclose(a, b, atol=1e-6)
    x, dt = torch.randn(1, 8, 2, 16, generator=g), torch.rand(1, 8, 2)
    bm = torch.randn(1, 8, 2, 8, generator=g, requires_grad=True)
    y, fin = sk.ssd_chunk_scan(x, dt, -dt, bm, bm.detach(), chunk=4)
    (y.sum() + fin.sum()).backward()
    assert bm.grad is not None and torch.isfinite(bm.grad).all()


# ---------------------------------------------------------------------------
# rule registry
# ---------------------------------------------------------------------------

def test_rule_registry_latest_wins_and_loud_unknown():
    class Probe(LintRule):
        name = "test_probe_rule"
        description = "x"

        def applies(self, t):
            return False

        def check(self, t):
            return []

    try:
        first, second = Probe(), Probe()
        register_rule(first)
        register_rule(second)
        assert get_rule("test_probe_rule") is second
        assert "test_probe_rule" in registered_rules()
        with pytest.raises(KeyError, match="registered rules"):
            get_rule("no_such_rule")
    finally:
        from repro_torch.lint.rules import _RULES
        _RULES.pop("test_probe_rule", None)


def test_registered_rules_are_the_references():
    assert registered_rules() == jax_lint.registered_rules()


def test_findings_serialize():
    f = Finding(rule="R", target="t", message="m", detail={"n": 1})
    d = f.to_dict()
    assert d["rule"] == "R" and d["detail"] == {"n": 1}
    assert "error" in str(f)


def test_run_rules_scopes_by_applies():
    ran, findings = run_rules(_target(phase="prefill", graph=_id_graph(2)))
    assert "NoHostTransferInStepLoop" not in ran  # decode-only rule
    assert findings == []


# ---------------------------------------------------------------------------
# negative fire: every built-in rule must trigger on a bad program
# ---------------------------------------------------------------------------

def test_no_forbidden_matmul_fires_when_q_is_left_in():
    """A "merged" program that is secretly the unmerged one: the same
    count as its source, where 2 fewer per attention layer are due."""
    a = _z(3, 3)
    f = walker.trace(lambda x: x @ a @ a, a)
    t = _target(style="merged", graph=f, source_graph=f, n_attn_layers=1)
    findings = NoForbiddenMatmul().check(t)
    assert findings and findings[0].rule == "NoForbiddenMatmul"
    assert findings[0].detail == {"merged": 2, "source": 2,
                                  "n_attn_layers": 1}
    # an honest delta of 2 per layer passes, and is per layer: two layers
    g = walker.trace(lambda x: x @ a @ a @ x @ a @ x @ a, a)
    assert NoForbiddenMatmul().check(_target(
        style="merged", graph=f, source_graph=g, n_attn_layers=2)) == []
    assert NoForbiddenMatmul().check(_target(
        style="merged", graph=f, source_graph=g, n_attn_layers=1))


def test_no_oversized_buffer_fires_on_max_len_intermediate():
    bad = walker.trace(lambda x: (_z(1, MAX_LEN, 4) + x).sum(), _z(4))
    t = _target(phase="prefill", cache_kind="paged", graph=bad,
                max_len=MAX_LEN)
    findings = NoOversizedBuffer().check(t)
    assert findings and str(MAX_LEN) in findings[0].message
    assert NoOversizedBuffer().check(_target(
        phase="prefill", cache_kind="paged", graph=_id_graph(4),
        max_len=MAX_LEN)) == []


def test_donation_effective_fires_on_a_cloned_pool():
    """A program that copies the pool out of place and returns the copy:
    both the storage check and the copy scan fire; the in-place write
    passes."""
    pool = _z(6, 8, dtype=torch.bfloat16)

    def cloned(p):
        q = p.clone()
        q[0] = 1
        return q

    def in_place(p):
        p[0] = 1
        return p

    out = {}
    for name, fn in (("bad", cloned), ("ok", in_place)):
        box = []
        g = walker.trace(lambda p: box.append(fn(p)) or box[-1], pool)
        out[name] = DonationEffective().check(_target(
            graph=g, donated=(("k", pool, box[0]),)))
    assert len(out["bad"]) == 2 and all(
        f.rule == "DonationEffective" for f in out["bad"])
    assert out["bad"][0].detail["not_in_place"] == ["k"]
    assert out["bad"][1].detail["copies"] == [["k", "aten.clone"]]
    assert out["ok"] == []
    assert not DonationEffective().applies(_target(graph=_id_graph(2)))


def test_dtype_promotion_drift_fires_on_fp32_shadow():
    k = _z(4, 8, dtype=torch.bfloat16)
    drift = walker.trace(lambda x: (x.float() + 1.0).to(torch.bfloat16), k)
    t = _target(graph=drift, cache_shapes=((4, 8),),
                cache_dtype=torch.bfloat16)
    findings = NoDtypePromotionDrift().check(t)
    assert findings and "float32" in str(findings[0].detail)
    clean = walker.trace(lambda x: x + 1, k)
    assert NoDtypePromotionDrift().check(_target(
        graph=clean, cache_shapes=((4, 8),),
        cache_dtype=torch.bfloat16)) == []


def test_no_dequantized_pool_buffer_fires_on_fp32_shadow():
    """``pool.float()`` — the convenience bug the rule exists for — must
    fire; gathered-row dequant (other shapes) must not; an int32 shadow
    fires too; the rule judges paged_q8 programs only."""
    shape = (6, 8, 2, 4)
    pool = _z(*shape, dtype=torch.int8)
    scale = _z(6, 2)

    def bad(p, s):
        return (p.float() * s[:, None, :, None]).sum()

    def clean(p, s):
        idx = torch.tensor([0, 2])
        return (p[idx].float() * s[idx][:, None, :, None]).sum()

    def q8(fn, *a):
        return _target(cache_kind="paged_q8", graph=walker.trace(fn, *a),
                       cache_shapes=(shape,), cache_dtype=torch.int8)

    findings = NoDequantizedPoolBuffer().check(q8(bad, pool, scale))
    assert findings and "float32" in str(findings[0].detail)
    assert NoDequantizedPoolBuffer().check(q8(clean, pool, scale)) == []
    assert NoDequantizedPoolBuffer().check(
        q8(lambda p: p.to(torch.int32).sum(), pool))
    assert not NoDequantizedPoolBuffer().applies(
        _target(cache_kind="paged", cache_shapes=(shape,)))


def test_host_transfer_fires_on_item_in_step():
    def leaky(x):
        n = int(x[0])  # a value read on the host
        return x * n

    findings = NoHostTransferInStepLoop().check(
        _target(graph=walker.trace(leaky, torch.ones(3))))
    assert findings and "host" in findings[0].message
    assert findings[0].detail["ops"] == ["aten._local_scalar_dense"]
    assert NoHostTransferInStepLoop().check(_target(graph=_id_graph(3))) \
        == []


def test_obs_hooks_rule_fires_on_an_observer_only_sync():
    """A program that consults the active observer and syncs when obs is
    on: the count DIFF between the plain and instrumented traces fires,
    not mere presence."""
    def f(x):
        if obs.get_active().enabled:  # the forbidden temptation
            x = x + torch.nonzero(x).sum()
        return x * 2

    plain = walker.trace(f, torch.ones(3))
    with obs.activated(obs.Observer(trace_capacity=16)):
        instr = walker.trace(f, torch.ones(3))
    findings = NoHostTransferInObsHooks().check(
        _target(graph=plain, instrumented_graph=instr))
    assert findings and findings[0].rule == "NoHostTransferInObsHooks"
    assert findings[0].detail["new"] == {"aten.nonzero": 1}
    assert "host-side" in findings[0].message


def test_obs_hooks_rule_quiet_on_identical_and_preexisting_syncs():
    clean = _id_graph(3)
    assert NoHostTransferInObsHooks().check(
        _target(graph=clean, instrumented_graph=clean)) == []
    leaky = walker.trace(lambda x: x + torch.nonzero(x).sum(), torch.ones(3))
    assert NoHostTransferInObsHooks().check(
        _target(graph=leaky, instrumented_graph=leaky)) == []
    assert not NoHostTransferInObsHooks().applies(_target(graph=clean))


# ---------------------------------------------------------------------------
# the registry sweep
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sweep_report():
    return sweep(device="cpu")


def test_sweep_covers_every_registered_backend(sweep_report):
    rep = sweep_report
    assert (rep.n_decode_targets, rep.n_prefill_targets,
            rep.n_chunk_targets) == (12, 12, 12)
    assert rep.n_decode_targets == len(backends.registered_backends())
    assert rep.n_prefill_targets == len(
        backends.registered_prefill_backends())
    assert rep.n_chunk_targets == len(backends.registered_chunk_backends())
    assert rep.ok, [str(f) for f in rep.findings]
    by_key = {t.key: t for t in rep.targets}
    assert len(by_key) == len(rep.targets) == 36
    for t in rep.targets:
        if t.style == "merged":
            assert "NoForbiddenMatmul" in t.rules_run, t.key
        if t.phase == "prefill" and t.cache_kind in ("paged", "paged_q8"):
            assert "NoOversizedBuffer" in t.rules_run, t.key
        if t.cache_kind == "paged_q8":
            assert "NoDequantizedPoolBuffer" in t.rules_run, t.key
        if t.phase == "decode":
            assert "NoHostTransferInStepLoop" in t.rules_run, t.key
        assert "NoDtypePromotionDrift" in t.rules_run, t.key
        assert "NoHostTransferInObsHooks" in t.rules_run, t.key
        if t.phase == "decode" or t.cache_kind != "dense":
            # the engine and the adapters write these caches in place
            assert "DonationEffective" in t.rules_run, t.key
        assert t.device == "cpu" and t.launches == 0


def test_kernel_targets_hold_one_kernel_node_per_attention_layer(
        sweep_report):
    """Each "cuda" decode and prefill program calls its kernel once per
    attention layer, as one node; chunk programs attend through the eager
    positions core on every impl (as the reference's do), and the plain
    route holds no kernel node."""
    for t in sweep_report.targets:
        if t.impl == "cuda" and t.phase != "chunk":
            assert t.n_kernel_nodes == t.n_attn_layers == 2, t.key
        else:
            assert t.n_kernel_nodes == 0, t.key


def _jax_dot_generals(closed):
    """dot_general equations of a jaxpr, recursing into every inner
    jaxpr (scan bodies, cond branches, pjit calls); and the lengths of
    its scans."""
    stack, n, scans = [closed.jaxpr], 0, []
    while stack:
        jx = stack.pop()
        for e in jx.eqns:
            n += e.primitive.name == "dot_general"
            if e.primitive.name == "scan":
                scans.append(e.params["length"])
            for p in e.params.values():
                for sub in jax.tree.leaves(p, is_leaf=lambda x: isinstance(
                        x, (jex.Jaxpr, jex.ClosedJaxpr))):
                    if isinstance(sub, jex.ClosedJaxpr):
                        stack.append(sub.jaxpr)
                    elif isinstance(sub, jex.Jaxpr):
                        stack.append(sub)
    return n, scans


@contextlib.contextmanager
def _reference_builders_without_lowering():
    """The reference's sweep builders, their jit lowering and observer
    re-trace switched off (only the plain jaxpr is wanted)."""
    rs = importlib.import_module("repro.lint.sweep")
    saved = rs._try_lower, rs._instrumented_jaxpr
    rs._try_lower = lambda fn, donate, args: (None, (), None)
    rs._instrumented_jaxpr = lambda fn, *args: None
    try:
        yield rs
    finally:
        rs._try_lower, rs._instrumented_jaxpr = saved


def test_matmul_delta_against_the_reference(sweep_report):
    """For each phase and cache kind the reference's merged jaxpr has 2
    fewer dot_generals than its source, inside one scanned layer body
    (scan length = layers); the port's graph has 2 fewer matmuls per
    attention layer, on both impls."""
    port = {(t.phase, t.cache_kind, t.style, t.impl): t
            for t in sweep_report.targets}
    with _reference_builders_without_lowering() as rs:
        models = rs.sweep_models()
        n_layers = models["generic"][0].n_layers
        for phase, builders in (("decode", rs._DECODE_BUILDERS),
                                ("prefill", rs._PREFILL_BUILDERS),
                                ("chunk", rs._CHUNK_BUILDERS)):
            for ck in ("dense", "paged", "paged_q8"):
                (g, g_scans), (m, m_scans) = (
                    _jax_dot_generals(builders[ck](*models[st],
                                                   "xla")["jaxpr"])
                    for st in ("generic", "merged"))
                assert g - m == 2, (phase, ck, g, m)
                assert g_scans == m_scans == [n_layers], (phase, ck)
                for impl in ("torch", "cuda"):
                    src = port[(phase, ck, "generic", impl)]
                    mrg = port[(phase, ck, "merged", impl)]
                    assert src.n_matmuls - mrg.n_matmuls == \
                        2 * mrg.n_attn_layers == 2 * n_layers, (
                            phase, ck, impl)


def test_sweep_flags_unregisterable_combo_loudly():
    """A registered backend the sweep has no builder for must be a loud
    SweepCoverage ERROR, never a silently unlinted combo."""
    step = backends.get_backend("dense", "generic", "torch").step
    backends.register_backend("quantized9", "generic", step,
                              impls=("probe",))
    try:
        rep = sweep(impls=("probe",))
        assert not rep.ok
        cov = [f for f in rep.findings if f.rule == "SweepCoverage"]
        assert cov and "quantized9" in cov[0].target
        assert rep.n_decode_targets == 1
        assert rep.n_prefill_targets == rep.n_chunk_targets == 0
    finally:
        from repro_torch.models.backends import _REGISTRY
        _REGISTRY.pop(("quantized9", "generic", "probe"), None)


def test_sweep_refuses_a_max_len_that_collides_with_a_dimension():
    cfg = SW.sweep_models()["generic"][0]
    SW.check_max_len(cfg)
    with pytest.raises(ValueError, match="collides"):
        SW.check_max_len(cfg.with_(d_ff=SW.SWEEP_MAX_LEN))


# ---------------------------------------------------------------------------
# the paged decode step: no host sync, idle rows write nothing new
# ---------------------------------------------------------------------------

def test_paged_decode_graph_holds_no_host_sync(sweep_report):
    """No paged or paged_q8 decode program, on either impl, reads device
    data on the host; the paged prefill and chunk programs still select
    their pages with ``torch.nonzero`` (the rule judges decode only, as
    the reference's does)."""
    for t in sweep_report.targets:
        if t.phase == "decode" or t.cache_kind == "dense":
            assert t.host_syncs == [], t.key
        else:
            assert t.host_syncs == ["aten.nonzero"], t.key


@pytest.fixture(scope="module")
def sweep_models():
    return SW.sweep_models()


def _pools(cache):
    return [t.clone() for t in cache
            if isinstance(t, torch.Tensor) and t.dim() >= 3]


@pytest.mark.parametrize("kind", ["paged", "paged_q8"])
def test_paged_step_writes_the_mapped_rows_only(sweep_models, kind):
    """A step over four rows, two of them idle (table all -1), leaves the
    pools exactly as the same step over the two mapped rows alone; a step
    with no mapped row leaves them bit for bit as they were."""
    from repro_torch.models import init_paged_cache, init_paged_q8_cache
    cfg, params = sweep_models["merged"]
    init = init_paged_q8_cache if kind == "paged_q8" else init_paged_cache
    g = torch.Generator().manual_seed(0)

    def fresh(n_rows):
        c = init(cfg, 12, 8, n_rows, 64, device="cpu")
        for t in c:
            if t.dim() >= 3:
                t.copy_((torch.randn(t.shape, generator=g) * 30).to(t.dtype)
                        if t.dtype != torch.float32
                        else torch.rand(t.shape, generator=g) + 0.01)
        return c

    base = fresh(4)
    tbl = torch.tensor([[-1] * 8, [3, 4, 5, -1, -1, -1, -1, -1],
                        [-1] * 8, [6, 7, -1, -1, -1, -1, -1, -1]],
                       dtype=torch.int32)
    length = torch.tensor([5, 17, 0, 8], dtype=torch.int32)
    toks = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    full = base._replace(block_tables=tbl, length=length)
    sub_pools = [t.clone() for t in base]
    sub = type(base)(*sub_pools)._replace(block_tables=tbl[[1, 3]],
                                          length=length[[1, 3]])
    forward_step(params, cfg, toks, full)
    forward_step(params, cfg, toks[[1, 3]], sub)
    for a, b in zip(_pools(full), _pools(sub)):
        assert torch.equal(a, b)
    idle = fresh(2)
    idle = idle._replace(length=torch.tensor([3, 9], dtype=torch.int32))
    before = _pools(idle)
    forward_step(params, cfg, toks[:2], idle)
    for a, b in zip(_pools(idle), before):
        assert torch.equal(a, b)
    assert isinstance(full, PagedQ8DecodeCache) == (kind == "paged_q8")
