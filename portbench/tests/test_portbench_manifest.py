"""BENCHMARK.json against the contract it is checked by, the files it
names, and the imports of every module under portbench/."""
import ast
import json
import re
from pathlib import Path

import pytest

import portbench_tiny  # noqa: F401  (paths)

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
WIDTH = re.compile(r"^(hidden|intermediate|latent|state|proj|head)\w*_size$"
                   r"|_dim$|_rank$|expan|experts_per_tok")


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert all(LINE.match(w) for w in MANIFEST["command"])
    assert (ROOT / MANIFEST["command"][1]).exists()


def test_names_and_units():
    names = []
    for c in MANIFEST["configs"]:
        names.append(c["name"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) and not WIDTH.search(k)
                   for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        names.append(w["name"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and LINE.match(w["why"])
    for sec in ("end_to_end", "per_layer"):
        for m in MANIFEST[sec]:
            names.append(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                              "higher")
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


def test_files_found_by_name():
    cells = {w["name"]: w for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        spec = json.loads((ROOT / c["file"]).read_text())
        assert spec["name"] == c["name"] and spec["source"] == c["source"]
        assert spec["reduced"] == c["reduced"]
    for name, w in cells.items():
        assert (BENCH / "configs" / f"{w['config']}.json").exists()
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        limit = json.loads((BENCH / "limits" / f"{name}.json").read_text())
        assert limit and set(limit) <= {"max_logit_gap", "mean_logit_gap"}
        assert all(v > 0 for v in limit.values())
    for sec in ("end_to_end", "per_layer"):
        for m in MANIFEST[sec]:
            assert (BENCH / "metrics" / f"{m['name']}.py").exists()
            assert set(m.get("workloads", cells)) <= set(cells)


@pytest.mark.parametrize("path", sorted((BENCH / "configs").glob("*.json")),
                         ids=lambda p: p.stem)
def test_block_found_by_name(path):
    """A configuration's ``reference`` names its weight maker and its
    plain model; a number under ``assumed`` is what runs, the source's key
    of that name stays in the file."""
    from portbench import harness

    spec = json.loads(path.read_text())
    wmod = harness.block("weights", spec)
    assert callable(wmod.make) and callable(wmod.check_port)
    assert callable(harness.block("reference", spec).logits)
    s = wmod.shapes(spec)
    run_in_place = {k: v for k, v in spec["assumed"].items()
                    if not isinstance(v, str)}
    for key, v in run_in_place.items():
        assert key in spec and spec[key] != v
        assert key not in spec["reduced"]
    assert s["eps"] == run_in_place.get("rms_norm_eps", spec["rms_norm_eps"])
    assert (s["d"], s["L"]) == (spec["hidden_size"],
                                spec["num_hidden_layers"])


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())

    def reports(m, cell):
        return "workloads" not in m or cell in m["workloads"]

    for w in MANIFEST["workloads"]:
        mine = [n for n, m in e2e.items() if reports(m, w["name"])]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(reports(m, w["name"]) for m in MANIFEST["per_layer"])
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and LINE.match(m["layer"])
        for cell in m["workloads"]:
            assert reports(e2e[m["moves"]], cell)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_a_reference_of_its_own(path):
    """Top-level names compared whole: ``repro_torch`` is not ``repro``."""
    names = set(_imports(path))
    assert not names & {"jax", "jaxlib", "flax", "repro"}
    if path.parent.name == "reference":
        assert "repro_torch" not in names
    if path.parent.name != "tests":  # the JAX package's benchmarks stay
        assert "benchmarks/" not in path.read_text()


@pytest.mark.parametrize("steps,share", [
    (((9.5, [3000]), (10.2, [16, 16, 608]), (10.6, [1, 944]),
      (11.5, [3000])), 25.0),
    (((9.5, [3000]), (11.5, [3000])), None)])
def test_pool_share_of_the_window_steps(steps, share):
    """The mean over the window's steps of the live contexts' whole pages
    over the pool's pages; nothing to read without a step in the window
    or without a paged pool."""
    from portbench import harness

    read = harness.reader("pool_used_pct.tput")
    run = harness.Run(cell="c", s={}, mix={"serve": {"block_size": 16}},
                      seconds=1.0, t0=10.0, t_end=11.0, pool_pages=200)
    run.steps = [harness.Step(t, t + 0.1, ctx, False) for t, ctx in steps]
    assert read(run) == (share if share is None else pytest.approx(share))
    run.pool_pages = None
    assert read(run) is None
