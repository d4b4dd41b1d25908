"""The port's three audits (``repro_torch.lint.aliasing``, ``submitpath``
and ``retention``) clean on real port engines and managers, firing on the
reference's sabotaged cases, with the same rule names and finding counts
as the reference's audits (``repro.lint``) on the same scenarios.

Tolerance: none — findings are counted, not measured.  The port serves
the reduced Llama-3.2-1B at head dim 64 (``submitpath.audit_model``), the
reference its reduced Llama-3.2-1B; the scenarios' prompts, slots,
budgets and pool sizes are the reference tests' (``tests/test_lint.py``,
``tests/test_sched.py``), so the serve loops make the same calls.
"""
import collections
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.lint import aliasing as jax_aliasing
from repro.lint import retention as jax_retention
from repro.lint import submitpath as jax_submitpath
from repro.models import init_params as jax_init_params
from repro.serving import Engine as JaxEngine
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving.hostbufs import aligned_empty
from repro.serving.paged_kv_cache import \
    PagedCacheManager as JaxPagedCacheManager
from repro.serving.paged_kv_cache import PagedDecodeCache as JaxPagedCache
from repro_torch.lint import aliasing, retention, submitpath
from repro_torch.serving import (Engine, SchedConfig, ScheduledEngine,
                                 ServeConfig)
from repro_torch.serving.paged_kv_cache import PagedCacheManager


@pytest.fixture(scope="module")
def port_model():
    return submitpath.audit_model("cpu")


@pytest.fixture(scope="module")
def jax_model():
    cfg = jax_reduce_config(jax_get_config("llama3.2-1b"))
    return cfg, jax_init_params(jax.random.PRNGKey(0), cfg)


def _port_engine(port_model, kind, n_slots=2):
    cfg, params = port_model
    return Engine(cfg, params, ServeConfig(n_slots=n_slots, max_len=48),
                  impl="torch", cache=kind, device="cpu")


def _jax_engine(jax_model, kind, n_slots=2):
    cfg, params = jax_model
    return JaxEngine(cfg, params, JaxServeConfig(n_slots=n_slots,
                                                 max_len=48), cache=kind)


def _tally(findings):
    return sorted(collections.Counter(f.rule for f in findings).items())


def _jax_prompts(engine):
    # the reference's aligned prompts (``aliasing._default_prompts``):
    # JAX's CPU import zero-copies them, as torch.from_numpy always does
    return jax_aliasing._default_prompts(engine)


# ---------------------------------------------------------------------------
# aliasing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "paged", "paged_q8"])
def test_aliasing_audit_clean_on_real_engines(port_model, jax_model, kind):
    port = aliasing.audit_engine(_port_engine(port_model, kind))
    assert port == [], [str(f) for f in port]
    assert jax_aliasing.audit_engine(_jax_engine(jax_model, kind)) == []


def test_aliasing_flags_noncopying_device_cache(port_model, jax_model):
    """The block table and lengths handed to the step without a copy:
    the program-boundary spy fires on both, as often as the reference's
    jit-boundary spy does."""
    eng = _port_engine(port_model, "paged")

    def bad(self, upload=None):  # the manager's signature, no copy
        return self._pools._replace(
            block_tables=torch.from_numpy(self.tables),
            length=torch.from_numpy(self.lengths))

    eng.kv.pm.device_cache = types.MethodType(bad, eng.kv.pm)
    port = aliasing.audit_engine(eng)
    assert any(f.rule == aliasing.RULE_JIT_INPUT and "pm.tables" in f.message
               for f in port)

    ref = _jax_engine(jax_model, "paged")

    def jax_bad(self):
        return JaxPagedCache(k=self.k, v=self.v,
                             block_tables=jnp.asarray(self.tables),
                             length=jnp.asarray(self.lengths))

    ref.kv.pm.device_cache = types.MethodType(jax_bad, ref.kv.pm)
    ref = jax_aliasing.audit_engine(ref)
    assert _tally(port) == _tally(ref)
    assert sorted(f.detail["buffer"] for f in port) == sorted(
        f.detail["buffer"] for f in ref)


def test_aliasing_flags_zero_copy_ingestion(port_model, jax_model):
    """Drop the copy at the host->device seam: the seam check fires once
    and the decode seam once per step (the last-token row reaches the
    step), as often as the reference's.  The port's prefill seam also
    sees each fresh prompt: the adapter gets ``host_to_device(row)[None]``,
    a VIEW of the caller's buffer in torch, where the reference's
    ``[None]`` on a jax array makes a new buffer."""
    eng = _port_engine(port_model, "dense")
    eng.host_to_device = lambda x, dtype=None: torch.from_numpy(
        np.asarray(x, dtype))
    port = aliasing.audit_engine(eng)
    ref = _jax_engine(jax_model, "dense")
    ref.host_to_device = lambda x, dtype=None: jnp.asarray(
        np.asarray(x, dtype))
    ref = jax_aliasing.audit_engine(ref)
    assert {f.rule for f in port} == {f.rule for f in ref} == {
        aliasing.RULE_INGEST, aliasing.RULE_JIT_INPUT}

    def by_seam(findings):
        return sorted(collections.Counter(
            (f.rule, f.target, (f.detail or {}).get("buffer", "")[:6])
            for f in findings).items())

    prefill = [f for f in port if f.target == "engine.kv._prefill"]
    assert sorted(f.detail["buffer"] for f in prefill) == [
        "prompt[0]", "prompt[1]", "prompt[2]"]
    assert by_seam([f for f in port if f not in prefill]) == by_seam(ref)


def test_check_host_views_flags_views_and_passes_owned_state():
    """A generator state that views another tensor's storage, or a
    read-only numpy view, is flagged; an owned copy is not — the same
    counts as the reference's check on its numpy cases."""
    state = torch.Generator().get_state()
    assert aliasing.check_host_views({"k": state}, "t") == []
    view = aliasing.check_host_views({"k": torch.cat([state, state])[1:]},
                                     "t")
    assert [f.rule for f in view] == [aliasing.RULE_HOST_VIEW]
    ro = np.zeros(3)
    ro.flags.writeable = False
    port = aliasing.check_host_views({"a": ro, "b": np.zeros(3)[1:],
                                      "c": np.zeros(3)}, "t")
    ref = jax_aliasing.check_host_views({"a": ro, "b": np.zeros(3)[1:],
                                         "c": np.zeros(3)}, "t")
    assert _tally(port) == _tally(ref) == [(aliasing.RULE_HOST_VIEW, 2)]


def test_preempted_key_state_owns_its_memory(port_model):
    """A sampled request's generator state, handed back at preemption,
    owns its storage, and the request resumes to completion."""
    from repro_torch.serving import Request
    cfg, params = port_model
    eng = Engine(cfg, params, ServeConfig(n_slots=2, max_len=48,
                                          temperature=0.8, seed=1),
                 impl="torch", cache="paged", device="cpu")
    p = np.arange(8, dtype=np.int32) % cfg.vocab_size
    assert eng.submit(Request(prompt=p, max_new_tokens=4))
    eng._preempt(next(iter(eng.active)))
    req = eng.preempted[0]
    assert req.key_state is not None
    assert aliasing.check_host_views({"key_state": req.key_state}, "t") == []
    assert eng.submit(req)
    while eng.active:
        eng.step()
    assert len(req.out_tokens) >= 4


def test_engine_declares_its_host_mutable_buffers(port_model, jax_model):
    port = _port_engine(port_model, "paged").host_mutable_buffers()
    ref = _jax_engine(jax_model, "paged").host_mutable_buffers()
    assert set(port) == set(ref)
    assert all(isinstance(b, np.ndarray) for b in port.values())
    assert _port_engine(port_model, "dense").host_mutable_buffers().keys() \
        == _jax_engine(jax_model, "dense").host_mutable_buffers().keys() \
        == {"engine._last_token"}


# ---------------------------------------------------------------------------
# submit path
# ---------------------------------------------------------------------------

def test_submit_audit_clean_with_positive_control(port_model):
    """Scheduled dense and paged engines enqueue only; the synchronous
    engine's prefill is observed (the positive control)."""
    cfg, params = port_model
    findings = submitpath.audit_submit_path(cfg, params, device="cpu")
    assert findings == [], [str(f) for f in findings]


def test_submit_audit_fires_on_synchronous_engine(port_model, jax_model):
    """The negative control: the synchronous engine's submit dispatches
    its prefill through the spied seam — the same findings as the
    reference's audit of its synchronous engine."""
    port = submitpath.audit_submit(_port_engine(port_model, "dense", 4),
                                   "sync")
    ref = jax_submitpath.audit_submit(_jax_engine(jax_model, "dense", 4),
                                      "sync")
    assert port and _tally(port) == _tally(ref)
    assert [f.detail for f in port] == [f.detail for f in ref]


def test_submit_positive_control_fails_vacuous_spies(port_model):
    class _Deaf:
        """An 'engine' whose submit never touches the spied seams."""
        def __init__(self, real):
            self.kv, self.cfg = real.kv, real.cfg
            self._decode = lambda *a, **k: None

        def submit(self, req, vision=None):
            return True

    deaf = _Deaf(_port_engine(port_model, "dense"))
    findings = submitpath.positive_control(deaf, "deaf")
    assert len(findings) == 1
    assert "positive control FAILED" in findings[0].message


@pytest.mark.parametrize("kind", ["dense", "paged", "paged_q8"])
def test_scheduled_submit_enqueues_only(port_model, kind):
    cfg, params = port_model
    eng = ScheduledEngine(cfg, params, ServeConfig(n_slots=2, max_len=48),
                          SchedConfig(token_budget=32, chunk_tokens=16),
                          impl="torch", cache=kind, device="cpu")
    assert submitpath.audit_submit(eng, "sched") == []


# ---------------------------------------------------------------------------
# retention
# ---------------------------------------------------------------------------

def test_retention_audit_clean_on_real_managers():
    """fp absolute + ring + q8 managers AND the sabotaged positive
    control come back empty, as the reference's do."""
    findings = retention.audit_retention(device="cpu")
    assert findings == [], [str(f) for f in findings]


def _unchecked(cls):
    def bad(self, slot):
        info = self._slots[slot]
        li = int(self.lengths[slot]) // self.bs
        if self.ring or li >= len(info.blocks):
            return cls.ensure_appendable(self, slot)
        return True  # append in place even when the page is held
    return bad


def test_retention_audit_flags_write_into_shared_page(port_model,
                                                       jax_model):
    """Strip detach-on-shared from ensure_appendable: the append seam
    fires with the refcount evidence, as many times as the reference's."""
    pm = PagedCacheManager(port_model[0], n_slots=4, max_len=64,
                           block_size=8, n_blocks=24, device="cpu")
    pm.ensure_appendable = types.MethodType(_unchecked(PagedCacheManager),
                                            pm)
    port = retention.audit_manager(pm, "sabotaged")
    assert port and all(f.rule == retention.RULE_RETENTION for f in port)
    assert any(f.detail.get("seam") == "ensure_appendable"
               and f.detail.get("ref", 0) > 1 for f in port)
    ref_pm = JaxPagedCacheManager(jax_model[0], n_slots=4, max_len=64,
                                  block_size=8, n_blocks=24)
    ref_pm.ensure_appendable = types.MethodType(
        _unchecked(JaxPagedCacheManager), ref_pm)
    ref = jax_retention.audit_manager(ref_pm, "sabotaged")
    assert _tally(port) == _tally(ref)
    assert [f.detail for f in port] == [f.detail for f in ref]


def test_retention_audit_flags_eviction_of_live_page(port_model, jax_model):
    """Evict with the refcount guard stripped while a live slot re-shares
    the retained chain: the eviction seam flags every victim a request
    still reads, as the reference's does."""
    out = {}
    for name, mod, cls, cfg, kw in (
            ("port", retention, PagedCacheManager, port_model[0],
             {"device": "cpu"}),
            ("jax", jax_retention, JaxPagedCacheManager, jax_model[0], {})):
        pm = cls(cfg, n_slots=4, max_len=64, block_size=8, n_blocks=10,
                 **kw)
        findings = []
        with mod._armed(pm, findings, "sabotaged-evict"):
            prompt = (np.arange(27, dtype=np.int32) * 3 + 1) \
                % cfg.vocab_size
            assert pm.admit(0, prompt) == 0
            pm.release(0)                       # chain retained by the tree
            assert pm.admit(1, prompt.copy()) == 4  # warm hit: retained+live
            assert pm.tree.evict(4, lambda p: True)
        out[name] = findings
    assert any(f.detail.get("seam") == "tree.evict"
               and f.detail.get("ref", 0) != 1 for f in out["port"])
    assert [f.detail for f in out["port"]] == [f.detail for f in out["jax"]]


def test_reference_aligned_prompt_helper_is_what_the_port_mirrors():
    """The reference's default prompts and the port's hold the same
    tokens (the port's need no alignment: torch.from_numpy always
    shares)."""
    eng = types.SimpleNamespace(cfg=types.SimpleNamespace(vocab_size=128))
    port = aliasing._default_prompts(eng)
    ref = jax_aliasing._default_prompts(eng)
    assert [p.tolist() for p in port] == [p.tolist() for p in ref]
    assert aligned_empty((8,), np.int32).ctypes.data % 64 == 0
