"""Tiny copies of the benchmark's configurations and mixes for the CPU
tests: the same files with every width cut down, float32, and the port's
config overridden to match."""
import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import harness  # noqa: E402

TINY = dict(hidden_size=64, intermediate_size=96, num_attention_heads=4,
            num_key_value_heads=2, num_hidden_layers=2, vocab_size=256,
            torch_dtype="float32")


def spec(name: str, window: int = 0):
    """``configs/<name>.json`` at tiny widths (an MoE keeps 4 experts,
    top 2, dropless at capacity 2); ``window`` replaces its sliding
    window where given."""
    s = copy.deepcopy(harness.load("configs", name))
    s.update(TINY)
    if window:
        s["sliding_window"] = window
    ov = dict(s["port"]["overrides"], n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, d_head=16, d_ff=96, vocab_size=256,
              dtype="float32", param_dtype="float32",
              sliding_window=s["sliding_window"])
    if s.get("num_local_experts"):
        s.update(num_local_experts=4, num_experts_per_tok=2)
        ov.update(n_experts=4, experts_per_token=2, capacity_factor=2.0)
    s["port"] = dict(s["port"], overrides=ov)
    return s


def mix(name: str):
    """``traffic/<name>.json`` at 4 slots of 64 tokens; every request
    decodes (no first wave cut short), so that a decode fault shows in
    every finished request."""
    m = copy.deepcopy(harness.load("traffic", name))
    m.pop("first_wave", None)
    m["serve"].update(n_slots=4, max_len=64, block_size=8)
    m["prompt"].update(min=4, max=24)
    m["output"].update(min=4, max=16)
    for part in ("prompt", "output"):
        if "median" in m[part]:
            m[part]["median"] = 10
    if "sched" in m:
        m["sched"] = {"chunk_tokens": 16, "token_budget": 32}
        m.update(rate_per_s=20.0, lead_s=0.3, drain_s=60.0)
    # every finished request is compared, so that a fault in any slot
    # shows however few steps a loaded machine runs in the window
    m.update(backlog=128, trace_steps=8,
             check={"served_tokens": 10 ** 6, "max_requests": 10 ** 6,
                    "min_requests": 3})
    return m


LIMIT = {"max_logit_gap": 1e-3, "mean_logit_gap": 1e-4}  # float32 both


def run(config: str, traffic: str, window: int = 0, **kw):
    return harness.run_cell(f"{config}.{traffic}", spec(config, window),
                            mix(traffic), LIMIT, 2 ** 31 + 11, 0.5,
                            kw.pop("trace", False), device="cpu",
                            impl="torch", **kw)
