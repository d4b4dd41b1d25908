"""The port's iteration planner (``serving.sched.plan``, a copy of the
reference's) and the chunked lifecycle of its paged managers.

* Planner: ``tests/test_sched.py``'s unit semantics (budget accounting,
  FCFS head-blocking, the monolithic cost clamp, cursor resume) and the
  fixed mix of ``tests/test_sched_properties.py`` through its schedule
  checker, on the port's ``plan_iteration``.
* Manager: the fixed chunked lifecycles of ``tests/test_sched_properties
  .py`` (admit_chunked -> chunks -> finish -> decode steps -> release;
  windowed and not; the int8 manager's scale rows) replayed side by side
  on ``repro.serving.paged_kv_cache``'s managers and the port's, with
  prefix retention on (both defaults): equal tables, lengths, refcounts,
  free lists, shields and retained pages after every operation, page
  conservation (slot-mapped + tree-retained + free == pool), and on the
  int8 managers equal scale arrays in which every live page carries its
  own marker."""
import numpy as np
import pytest

from repro import configs as jcfg
from repro.serving import paged_kv_cache as jpkv
from repro_torch import configs as tcfg
from repro_torch.serving import paged_kv_cache as tpkv
from repro_torch.serving.engine import Request
from repro_torch.serving.sched import PrefillJob, SchedConfig, plan_iteration

MAX_LEN, BLOCK, N_BLOCKS = 64, 8, 10


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

def _job(n, monolithic=False, slot=0, cursor=0):
    r = Request(prompt=np.zeros((n,), np.int32), max_new_tokens=4)
    j = PrefillJob(req=r, toks=np.zeros((n,), np.int32),
                   monolithic=monolithic)
    j.slot, j.cursor = slot, cursor
    return j


def test_planner_budget_and_fcfs_head_blocking():
    scfg = SchedConfig(token_budget=16, chunk_tokens=8)
    jobs = [_job(20), _job(8), _job(8)]
    # 10 decode slots leave 6 < 8 of the budget: the HEAD does not fit,
    # and FCFS must not skip ahead to a later job
    s = plan_iteration(scfg, 10, jobs)
    assert s.chunks == [] and s.budget_used == 10
    # no decodes: the head always fits (budget >= chunk)
    s = plan_iteration(scfg, 0, jobs)
    assert [c.job for c in s.chunks] == [jobs[0], jobs[1]]
    assert s.budget_used == 16 and s.budget == 16
    assert (s.chunks[0].start, s.chunks[0].end, s.chunks[0].final) \
        == (0, 8, False)
    assert (s.chunks[1].start, s.chunks[1].end, s.chunks[1].final) \
        == (0, 8, True)


def test_planner_monolithic_cost_clamp_preserves_liveness():
    """A monolithic job longer than the whole budget charges min(total,
    budget), or it could never fit."""
    scfg = SchedConfig(token_budget=16, chunk_tokens=8)
    s = plan_iteration(scfg, 0, [_job(40, monolithic=True)])
    assert len(s.chunks) == 1
    c = s.chunks[0]
    assert (c.start, c.end, c.cost, c.final) == (0, 40, 16, True)
    # with even one decode active it waits (a clamp, not a zero cost)
    assert plan_iteration(scfg, 1, [_job(40, monolithic=True)]).chunks == []


def test_planner_skips_done_and_resumes_cursor():
    scfg = SchedConfig(token_budget=32, chunk_tokens=8)
    done = _job(8, cursor=8)
    mid = _job(20, cursor=8)
    s = plan_iteration(scfg, 0, [done, mid])
    assert [c.job for c in s.chunks] == [mid]
    assert (s.chunks[0].start, s.chunks[0].end, s.chunks[0].final) \
        == (8, 16, False)


def _check_schedule(scfg, n_decode, jobs, s):
    """``tests/test_sched_properties.py``'s schedule invariants."""
    unfinished = [j for j in jobs if not j.done]
    planned = [c.job for c in s.chunks]
    assert planned == unfinished[:len(planned)], "not an FCFS prefix"
    assert len(set(map(id, planned))) == len(planned)
    assert s.budget == scfg.token_budget and s.n_decode == n_decode
    cost = n_decode
    for c in s.chunks:
        assert c.start == c.job.cursor
        if c.job.monolithic:
            assert c.end == c.job.total
            assert c.cost == min(c.job.total, scfg.token_budget)
        else:
            assert c.end == min(c.start + scfg.chunk_tokens, c.job.total)
            assert c.cost == scfg.chunk_tokens
        assert c.final == (c.end >= c.job.total)
        cost += c.cost
    assert s.budget_used == cost
    if s.chunks:
        assert s.budget_used <= scfg.token_budget
    if n_decode == 0 and unfinished:
        assert s.chunks, "an idle iteration must schedule the queue head"


def test_planner_runs_without_hypothesis():
    scfg = SchedConfig(token_budget=16, chunk_tokens=8)
    jobs = [_job(20, slot=0), _job(40, monolithic=True, slot=1),
            _job(3, slot=2)]
    for n_decode in (0, 3, 17, 0, 0, 0, 0):
        s = plan_iteration(scfg, n_decode, jobs)
        _check_schedule(scfg, n_decode, jobs, s)
        for c in s.chunks:
            c.job.cursor = c.end
    assert all(j.done for j in jobs)


# ---------------------------------------------------------------------------
# manager: the chunked lifecycle, side by side with the JAX manager
# ---------------------------------------------------------------------------

def _conservation(pm):
    alloc = pm.allocator
    free = list(alloc._free)
    assert len(set(free)) == len(free), "double free"
    assert alloc.n_free + alloc.n_used == alloc.n_blocks
    holders = np.zeros((alloc.n_blocks,), np.int64)
    mapped = set()
    for info in pm._slots.values():
        live = [p for p in info.blocks if p >= 0]
        assert len(set(live)) == len(live) and not set(live) & set(free)
        holders[live] += 1
        mapped |= set(live)
    retained = set(pm.tree.retained)
    assert not retained & set(free)
    holders[list(retained)] += 1
    np.testing.assert_array_equal(alloc.ref, holders)
    assert mapped | retained | set(free) == set(range(alloc.n_blocks))
    assert pm.shielded <= set(pm._slots), "a shield on a dead slot"


class _Pair:
    """The JAX manager and the port's, driven op by op (``do``) and
    compared after each; on the int8 managers each newly mapped page gets
    a fresh marker in its scale rows on both sides (a copying
    copy-on-write moves its source's)."""

    def __init__(self, window, q8=False, n_slots=2, n_blocks=N_BLOCKS,
                 retention=True):
        kw = dict(n_slots=n_slots, max_len=MAX_LEN, block_size=BLOCK,
                  n_blocks=n_blocks, prefix_retention=retention)
        jc = jcfg.reduce_config(jcfg.get_config("mistral-7b")).with_(
            sliding_window=window)
        tc = tcfg.reduce_config(tcfg.get_config("mistral-7b")).with_(
            sliding_window=window)
        cls = "PagedQ8CacheManager" if q8 else "PagedCacheManager"
        self.j = getattr(jpkv, cls)(jc, **kw)
        self.t = getattr(tpkv, cls)(tc, device="cpu", **kw)
        self.q8, self.expected, self.marker = q8, {}, 1.0

    def _live(self):
        return {p for info in self.t._slots.values() for p in info.blocks
                if p >= 0}

    def do(self, name, *args):
        before = self._live()
        a0 = self.t.allocator
        cow0, rec0 = a0.n_cow, a0.n_recycled
        got = getattr(self.t, name)(*args)
        want = getattr(self.j, name)(*args)
        if isinstance(got, np.ndarray):
            np.testing.assert_array_equal(got, np.asarray(want), name)
        else:
            assert got == want, name
        if self.q8:
            after = self._live()
            new, gone = after - before, before - after
            if a0.n_cow > cow0 and a0.n_recycled == rec0 and \
                    len(new) == 1 and len(gone) == 1:
                self.expected[new.pop()] = self.expected[gone.pop()]
            for p in sorted(new):
                self._stamp(p)
        self.check(name)
        return got

    def match(self, toks):
        got = self.t.tree.match(toks)
        assert got == self.j.tree.match(toks)
        return got

    def _stamp(self, p):
        m, self.marker = self.marker, self.marker + 1.0
        self.expected[p] = m
        self.j.k_scale = self.j.k_scale.at[:, p].set(m)
        self.j.v_scale = self.j.v_scale.at[:, p].set(-m)
        self.t.k_scale[:, p] = m
        self.t.v_scale[:, p] = -m

    def check(self, where):
        j, t = self.j, self.t
        np.testing.assert_array_equal(t.tables, np.asarray(j.tables), where)
        np.testing.assert_array_equal(t.lengths, np.asarray(j.lengths),
                                      where)
        np.testing.assert_array_equal(t.allocator.ref,
                                      np.asarray(j.allocator.ref), where)
        assert t.allocator._free == j.allocator._free, where
        assert t.shielded == j.shielded, where
        assert t.tree.retained == j.tree.retained, where
        for k in ("n_cow", "n_shared_hits", "n_recycled", "peak_used"):
            assert getattr(t.allocator, k) == getattr(j.allocator, k), \
                (where, k)
        for k in ("n_pages", "n_nodes", "hit_tokens", "n_evicted"):
            assert getattr(t.tree, k) == getattr(j.tree, k), (where, k)
        _conservation(t)
        _conservation(j)
        if self.q8:
            np.testing.assert_array_equal(t.k_scale.numpy(),
                                          np.asarray(j.k_scale), where)
            np.testing.assert_array_equal(t.v_scale.numpy(),
                                          np.asarray(j.v_scale), where)
            for p in self._live():
                assert float(t.k_scale[0, p, 0]) == self.expected[p]


def _chunk_in(pair, slot, toks):
    """admit_chunked, every chunk of one block, finish, unshield."""
    assert pair.do("admit_chunked", slot, toks) is not None
    assert slot in pair.t.shielded
    f = 0
    while f < len(toks):
        end = min(f + BLOCK, len(toks))
        assert pair.do("ensure_chunk", slot, f, end)
        ids = pair.do("chunk_block_ids", slot, f, end, len(toks))
        assert not {int(p) for p in ids if p >= 0} & \
            set(pair.t.allocator._free), "chunk write routed at a free page"
        pair.do("set_frontier", slot, end)
        assert int(pair.t.lengths[slot]) == end
        f = end
    pair.do("finish_chunked", slot, toks)
    pair.do("unshield", slot)


def _decode(pair, slot, steps):
    for _ in range(steps):
        if pair.do("ensure_appendable", slot):
            pair.do("advance", slot)


@pytest.mark.parametrize("window", [0, 16])
def test_chunked_lifecycle_runs_without_hypothesis(window):
    """``tests/test_sched_properties.py``'s fixed lifecycle, then the
    same prompt again after release: a warm hit on the retained chain
    (absolute mode; ring mode neither shares nor registers)."""
    pair = _Pair(window)
    toks = np.arange(20, dtype=np.int32)
    _chunk_in(pair, 0, toks)
    _decode(pair, 0, 24)
    pair.do("release", 0)
    if not window:
        assert pair.t.tree.retained, "a released prefix must be retained"
        # the whole prompt matches: its trailing partial page too
        assert pair.do("admit_chunked", 1, toks.copy()) == 3
        pair.do("release", 1)
    pair.do("drop_prefix_cache")
    assert pair.t.allocator.n_used == 0 and pair.t.tree.n_pages == 0
    assert not pair.t.shielded


def test_chunked_q8_runs_without_hypothesis():
    """The fixed q8 lifecycle: chunks -> windowed decode over recycled
    pages -> release, the scale rows travelling with their pages."""
    pair = _Pair(16, q8=True)
    toks = np.arange(20, dtype=np.int32)
    _chunk_in(pair, 0, toks)
    _decode(pair, 0, 24)
    assert pair.t.allocator.n_recycled > 0, "windowed decode must recycle"
    pair.do("release", 0)
    assert pair.t.allocator.n_used == 0


def test_shielded_rows_ship_masked_and_chunks_share_finished_prefixes():
    """A mid-prefill slot's table row ships as -1 in ``device_cache()``
    while the manager keeps the true row; two identical prompts in flight
    at once do not share (registration waits for finish_chunked), a
    third admitted after the first finished does; starved admissions
    defer; self-preemption (release mid-prefill) conserves pages."""
    pair = _Pair(0, n_slots=4, n_blocks=8)
    a = (np.arange(20, dtype=np.int32) * 3 + 1) % 97
    assert pair.do("admit_chunked", 0, a) == 0
    assert pair.do("admit_chunked", 1, a.copy()) == 0  # in flight: no share
    view = pair.t.device_cache().block_tables.numpy()
    assert (view[0] == -1).all() and (view[1] == -1).all()
    assert (pair.t.tables[0, :3] >= 0).all()
    assert pair.do("admit_chunked", 2, np.arange(30, dtype=np.int32)) \
        is None, "6 pages in use, 4 more asked of 8: defer"
    pair.do("release", 1)  # self-preempt mid-prefill
    f = 0
    while f < len(a):
        end = min(f + BLOCK, len(a))
        pair.do("ensure_chunk", 0, f, end)
        pair.do("chunk_block_ids", 0, f, end, len(a))
        pair.do("set_frontier", 0, end)
        f = end
    pair.do("finish_chunked", 0, a)
    assert 0 in pair.t.shielded, "the shield stays until activation"
    pair.do("unshield", 0)
    assert (pair.t.device_cache().block_tables.numpy()[0, :3] >= 0).all()
    assert pair.do("admit_chunked", 3, a.copy()) == 3  # a finished resident
    ids = pair.do("chunk_block_ids", 3, 0, BLOCK, len(a))
    assert (ids == -1).all(), "shared pages are not rewritten"
    for s in (0, 3):
        pair.do("release", s)
    pair.do("drop_prefix_cache")
    assert pair.t.allocator.n_used == 0
