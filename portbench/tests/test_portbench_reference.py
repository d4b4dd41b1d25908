"""The plain reference against the port's plain PyTorch route on the CPU,
on both block kinds (dense SwiGLU and MoE) at tiny widths: the sequence
forward's logits, and a whole harness run through ``Engine`` and
``ScheduledEngine`` whose served tokens the reference finds at its best."""
import pytest
import torch

import portbench_tiny as tiny
from portbench import harness

CONFIGS = ("mistral7b-qpfree", "phi35moe-qpfree-l16")


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_port_forward(name):
    from repro_torch.models import forward_seq

    spec = tiny.spec(name, window=8)  # the window binds at 20 tokens
    wmod, ref = harness.block("weights", spec), harness.block("reference",
                                                             spec)
    s = wmod.shapes(spec)
    cfg = harness.port_config(spec)
    w = wmod.make(spec, 5, "cpu")
    harness.check_tree(w, cfg)
    toks = torch.randint(0, s["V"], (2, 20), generator=torch.Generator()
                         .manual_seed(3))
    port, _, _ = forward_seq(w, cfg, toks, impl="torch")
    got = ref.logits(w, s, list(toks), [0, 0])
    for b in range(2):
        torch.testing.assert_close(got[b], port[b, :, :s["V"]].float(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("config,traffic,window", [
    ("mistral7b-qpfree", "batch", 40),  # a ring of pages: the window binds
    ("phi35moe-qpfree-l16", "batch", 0),
    ("mistral7b-qpfree", "chat", 64),
])
def test_sound_run_is_correct(config, traffic, window):
    res = tiny.run(config, traffic, window)
    assert res["correct"], res["checks"]
    assert res["checks"]["max_logit_gap"]["value"] <= 1e-4
    assert res["compared"]["tokens"] > 0
    assert res["attempted"] > 0 and res["failed"] == 0
    pool = harness.reader("pool_used_pct.tput")(res["run"])
    if traffic == "chat":  # the open loop records no contexts
        assert pool is None
    else:
        assert 0 < pool <= 100


def test_control_reads_far_wider_than_the_program():
    """The float8 control, on the same served positions, reads a gap far
    above the float32 program's."""
    res = tiny.run("mistral7b-qpfree", "batch", control=True)
    for k, limit in tiny.LIMIT.items():
        assert res["checks"][k]["value"] <= limit / 10
        assert res["control"][k] > 10 * limit
