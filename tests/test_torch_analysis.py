"""The port's ``core/analysis.py`` against ``repro.core.analysis``: the
weight table, the weights read per decoded token and the paper's decode
speedup model for every config the port registers, the paper's §3 table
(Pythia-6.9B, Mistral-7B) as ``tests/test_merge.py`` pins it, the MoE
active-weight extension on Phi-3.5-MoE as ``tests/test_system.py`` does,
and the merge's removed-weight count on reduced configs.  Exact equality
(integer counts, the same float formulas)."""
import pytest

from repro import configs as jcfg
from repro.core import analysis as jan
from repro_torch import configs as tcfg
from repro_torch.core import analysis as tan
from repro_torch.core import merge_skipless, removed_weight_count
from repro_torch.models import init_params

PORT_ARCHS = tcfg.list_archs()


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_counts_equal_the_reference(arch):
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    assert tan.weight_table(tc) == jan.weight_table(jc)
    for with_qp in (True, False):
        assert tan.active_weights_per_token(tc, with_qp) == \
            jan.active_weights_per_token(jc, with_qp)
    for active in (False, True):
        assert tan.decode_speedup(tc, active) == \
            jan.decode_speedup(jc, active)
    n = tan.active_weights_per_token(tc)
    assert tan.decode_ms_per_token(n, hbm_gbps=3350.0) == \
        jan.decode_ms_per_token(n, hbm_gbps=3350.0)


def test_decode_ms_needs_the_bandwidth():
    with pytest.raises(TypeError):
        tan.decode_ms_per_token(10 ** 9)
    assert tan.decode_ms_per_token(10 ** 9, 2, hbm_gbps=2000.0,
                                   chips=2) == 0.5


@pytest.mark.parametrize("arch,exp", [
    ("pythia-6.9b", dict(qp=33_554_432, kv=33_554_432, ffn=134_217_728,
                         embed=412_876_800, total_b=6.9, wo_b=5.8,
                         savings=16, speedup=1.19)),
    ("mistral-7b", dict(qp=33_554_432, kv=8_388_608, ffn=176_160_768,
                        embed=262_144_000, total_b=7.2, wo_b=6.2,
                        savings=15, speedup=1.17)),
])
def test_paper_table(arch, exp):
    t = tan.weight_table(tcfg.get_config(arch))
    assert t["qp_per_layer"] == exp["qp"]
    assert t["kv_per_layer"] == exp["kv"]
    assert t["ffn_per_layer"] == exp["ffn"]
    assert t["embed"] == exp["embed"]
    assert round(t["total"] / 1e9, 1) == exp["total_b"]
    assert round(t["total_without_qp"] / 1e9, 1) == exp["wo_b"]
    assert round(t["savings_frac"] * 100) == exp["savings"]
    assert round(t["speedup"], 2) == exp["speedup"]
    assert abs(tan.decode_speedup(tcfg.get_config(arch)) - t["speedup"]) \
        < 1e-9


def test_moe_active_weight_speedup_extension():
    cfg = tcfg.get_config("phi3.5-moe-42b-a6.6b")
    total_model = tan.weight_table(cfg)["speedup"]
    active_model = tan.decode_speedup(cfg, active_only=True)
    assert active_model > total_model > 1.0
    assert tan.active_weights_per_token(cfg) < tan.weight_table(cfg)["total"]


MERGEABLE = [a for a in PORT_ARCHS
             if tcfg.get_config(a).has_attention
             and not tcfg.get_config(a).parallel_block
             and tcfg.get_config(a).family != "hybrid"]


@pytest.mark.parametrize("arch", MERGEABLE)
def test_merge_removes_the_table_count(arch):
    """On the reduced config, the qp merge removes exactly the table's
    count (a tied embedding is untied by the merge, and QKV biases trade
    bq for b_out and embed_bias: both corrected as the reference's
    ``tests/test_merge.py`` does)."""
    cfg = tcfg.reduce_config(tcfg.get_config(arch)).with_(
        block_style="skipless")
    params = init_params(cfg, seed=0, device="cpu")
    mp, _ = merge_skipless(params, cfg, "qp")
    expect = tan.weight_table(cfg)["removed"]
    d, L = cfg.d_model, cfg.n_layers
    if cfg.qkv_bias:  # the table counts bq in qp; b_out and embed_bias
        expect -= L * d + d  # are added
    if cfg.tie_embeddings:
        expect -= cfg.padded_vocab * d
    assert removed_weight_count(params, mp) == expect
