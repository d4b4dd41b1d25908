"""The traffic generator: deterministic from the seed, within each mix's
ranges, and the same sizes and gaps for every seed in another order."""
import collections

import numpy as np
import pytest

import portbench_tiny  # noqa: F401  (paths)
from portbench import harness
from portbench.traffic import generator

MIXES = ("batch", "chat")
SEED = 2 ** 31 + 7  # more than 32 signed bits hold


def _small(name):
    m = harness.load("traffic", name)
    m["backlog"] = 512
    return m


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    m = _small(name)
    a, b = generator.generate(m, SEED, 32000), generator.generate(m, SEED,
                                                                  32000)
    assert [(len(x.prompt), x.max_new, x.due) for x in a] == \
        [(len(x.prompt), x.max_new, x.due) for x in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    c = generator.generate(m, SEED + 1, 32000)
    assert not all(np.array_equal(x.prompt, y.prompt)
                   for x, y in zip(a, c))


@pytest.mark.parametrize("name", MIXES)
def test_ranges_kept(name):
    m = _small(name)
    items = generator.generate(m, SEED, 32000)
    lens = [len(x.prompt) for x in items]
    assert m["prompt"]["min"] <= min(lens) and max(lens) <= m["prompt"]["max"]
    first = int(m["serve"]["n_slots"]) if m.get("first_wave") else 0
    outs = [x.max_new for x in items[first:]]
    assert m["output"]["min"] <= min(outs) and max(outs) <= m["output"]["max"]
    assert all(1 <= x.max_new <= m["output"]["max"] for x in items[:first])
    assert all(len(x.prompt) + x.max_new <= m["serve"]["max_len"]
               for x in items)
    assert all(0 <= t < 32000 for x in items[:8] for t in x.prompt)
    if m["loop"] == "open":
        dues = [x.due for x in items]
        assert dues == sorted(dues) and dues[0] > 0
        rate = len(dues) / dues[-1]
        assert abs(rate / m["rate_per_s"] - 1) < 0.05


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_same_sizes(name):
    """Each block of ``strata`` requests holds the same sizes whatever the
    seed: only their order changes."""
    m = _small(name)
    k = int(m["strata"])
    first = int(m["serve"]["n_slots"]) if m.get("first_wave") else 0
    lo = -(-first // k) * k  # past the first wave's shortened budgets
    a = generator.generate(m, 1, 32000)[lo:lo + k]
    b = generator.generate(m, SEED, 32000)[lo:lo + k]
    for attr in (lambda x: len(x.prompt), lambda x: x.max_new):
        assert collections.Counter(map(attr, a)) == \
            collections.Counter(map(attr, b))


def test_quantiles():
    u = {"dist": "uniform", "min": 256, "max": 512}
    assert generator.quantile(u, 0.0) == 256
    assert generator.quantile(u, 0.999999) == 512
    ln = {"dist": "lognormal", "median": 1024, "sigma": 0.9, "min": 128,
          "max": 3584}
    assert generator.quantile(ln, 0.5) == 1024
    assert generator.quantile(ln, 1e-9) == 128
    assert generator.quantile(ln, 1 - 1e-9) == 3584


def test_warm_lengths_cover_every_bucket():
    m = {"prompt": {"min": 64, "max": 1024}}
    assert generator.warm_lengths(m) == [64, 128, 256, 512, 1024]
    assert generator.warm_lengths({"prompt": {"min": 3072, "max": 4096}}) \
        == [3072, 4096]
