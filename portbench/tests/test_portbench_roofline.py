"""Operation and byte counts against values worked out by hand."""
import pytest

import portbench_tiny  # noqa: F401  (paths)
from portbench import harness
from portbench.roofline import counts
from portbench.weights import qpfree

MISTRAL = qpfree.shapes(harness.load("configs", "mistral7b-qpfree"))
PHI = qpfree.shapes(harness.load("configs", "phi35moe-qpfree-l16"))


def test_band():
    assert counts.band(4, 0) == 10
    assert counts.band(4, 2) == 1 + 2 + 2 + 2
    assert counts.band(4096, 4096) == 4096 * 4097 // 2
    assert counts.band(4100, 4096) == 4096 * 4097 // 2 + 4 * 4096


def test_decode_attn():
    c = counts.decode_attn(MISTRAL, [100, 5000])
    keys = 100 + 4096  # the window clips the second
    assert c["bytes"] == 2 * (2 * keys * 8 * 128 + 2 * 2 * 32 * 128)
    assert c["flops"] == 4 * 32 * 128 * keys


def test_flash():
    c = counts.flash(MISTRAL, 256)
    assert c["bytes"] == 2 * 256 * (2 * 4096 + 2 * 1024)
    assert c["flops"] == 4 * 32 * 128 * (256 * 257 // 2)


def test_model_flops():
    # K and V (4096 -> 1024 each), SwiGLU 4096 -> 14336 -> 4096
    per_layer = 2 * 2 * 4096 * 1024 + 2 * 3 * 4096 * 14336
    assert counts.weight_flops_per_token(MISTRAL) == 32 * per_layer
    # two routed experts of 6400 and the 16-way router
    moe_layer = 2 * 2 * 4096 * 1024 + 2 * 2 * 3 * 4096 * 6400 + 2 * 4096 * 16
    assert counts.weight_flops_per_token(PHI) == 16 * moe_layer
    step = counts.decode_flops(MISTRAL, [10, 20])
    assert step == pytest.approx(2 * (32 * per_layer + 2 * 4096 * 32000)
                                 + 32 * 4 * 32 * 128 * 30)
    pre = counts.prefill_flops(MISTRAL, 8)
    assert pre == pytest.approx(8 * 32 * per_layer + 32 * 4 * 32 * 128 * 36
                                + 2 * 4096 * 32000)
