"""Model configuration system.

Every architecture in the framework is described by a single frozen
``ModelConfig``. Configs are registered by id (``--arch <id>``) in
``REGISTRY`` via the ``@register`` decorator; each assigned architecture
lives in its own module ``repro_torch.configs.<id>`` and is imported eagerly by
``repro_torch.configs.__init__`` so the registry is always fully populated.

The paper's technique (QP removal for skipless transformers) is selected
per-config via ``block_style``:

  standard         residual + RMSNorm blocks (the public-literature form)
  skipless         no residuals / no norms, full Q,K,V,P present (Fig 1a)
  skipless_merged  no residuals / no norms, Q and P removed (Fig 1b) —
                   mathematically identical to ``skipless`` under the
                   core.merge transform
  residual_qpfree  paper Fig 4: Q/P-free blocks *with* norms and skips
                   (a trainable architecture, not an exact rewrite)

``parallel_block`` selects the GPT-J-style attention-parallel-to-FFN layout
(paper Fig 3); the serial layout is paper Fig 1.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

BLOCK_STYLES = ("standard", "skipless", "skipless_merged", "residual_qpfree")
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str  # one of FAMILIES
    source: str = ""  # provenance note "[hf:...; tier]"

    # trunk
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0  # 0 => attention-free (ssm)
    n_kv_heads: int = 0
    d_head: int = 0  # defaults to d_model // n_heads
    d_ff: int = 0  # 0 => no FFN (mamba2)
    vocab_size: int = 0

    # attention
    rope_style: str = "half"  # "half" | "chatglm2d" | "none"
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0  # fraction of d_head that is rotated
    qkv_bias: bool = False
    sliding_window: int = 0  # 0 = full attention
    causal: bool = True  # False => encoder-only (no decode shapes)

    # ffn
    ffn_type: str = "swiglu"  # "swiglu" | "geglu" | "gelu_mlp"

    # moe
    n_experts: int = 0
    experts_per_token: int = 0
    router_jitter: float = 0.0
    capacity_factor: float = 1.25

    # ssm / hybrid (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_n_groups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # vlm cross-attention
    cross_attn_every: int = 0  # every Nth layer is cross-attn (0 = none)
    n_vision_tokens: int = 0

    # paper technique
    block_style: str = "standard"
    merged_variant: str = "qp"  # which pair is removed: "qp" | "kp" | "vp" (Table 1)
    parallel_block: bool = False  # attention parallel to FFN (paper Fig 3)

    # lowering/analysis knobs (loop tiling; analysis mode unrolls these)
    query_chunk: int = 1024  # attention query-block tiling (0 = unchunked)
    moe_group: int = 2048  # MoE dispatch group size (0 = single group)
    moe_impl: str = "scatter"  # "scatter" (linear dispatch) | "einsum" (GShard ref)
    init_style: str = "auto"  # "auto": orthogonal for skipless styles, else normal
    ffn_out_gain: float = 1.0  # skipless signal-prop compensation on w_down/w_out

    # numerics
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    tie_embeddings: bool = False

    # positional fallback for rope_style == "none" (encoder)
    conv_pos_width: int = 0  # hubert-style depthwise conv positional embed

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.block_style not in BLOCK_STYLES:
            raise ValueError(f"unknown block_style {self.block_style!r}")
        if self.n_heads and not self.d_head:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_heads and not self.n_kv_heads:
            object.__setattr__(self, "n_kv_heads", self.n_heads)
        if self.n_heads and self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    # ---- derived quantities used across the framework -------------------

    @property
    def padded_vocab(self) -> int:
        """Physical embedding rows: vocab padded to a multiple of 128 so the
        vocab dim shards evenly over any TP degree up to 128 (production
        practice; logits for padded ids are masked in loss/sampling).
        The LOGICAL ``vocab_size`` is unchanged (paper tables use it)."""
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def attn_dim(self) -> int:
        """Output dim of the Q projection / attention concat (n_heads*d_head)."""
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        """Paper's ``e``: output dim of K and V (n_kv_heads * d_head)."""
        return self.n_kv_heads * self.d_head

    @property
    def is_glu(self) -> bool:
        return self.ffn_type in ("swiglu", "geglu")

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0

    @property
    def has_ffn(self) -> bool:
        return self.d_ff > 0

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def qp_removal_applicable(self) -> bool:
        """Paper Fig 1(b)/3(a): needs attention with a square (d x d) Q.

        True for every attention-bearing arch (MHA/MQA/GQA alike); False for
        attention-free SSMs.  KP/VP variants additionally need kv_dim == d.
        """
        return self.has_attention and self.attn_dim == self.d_model

    @property
    def kp_vp_removal_applicable(self) -> bool:
        """Paper Fig 1(c)/(d): MHA only (e == d)."""
        return self.has_attention and self.kv_dim == self.d_model

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate_style(self) -> None:
        if self.block_style in ("skipless_merged", "residual_qpfree") and (
            not self.qp_removal_applicable
        ):
            raise ValueError(
                f"{self.name}: block_style={self.block_style} requires a "
                "square Q projection (attention-bearing arch)"
            )
        if self.merged_variant not in ("qp", "kp", "vp"):
            raise ValueError(f"unknown merged_variant {self.merged_variant!r}")
        if (self.block_style == "skipless_merged"
                and self.merged_variant in ("kp", "vp")
                and not self.kp_vp_removal_applicable):
            raise ValueError(
                f"{self.name}: merged_variant={self.merged_variant} requires "
                "MHA (e == d, paper Fig 1c/d); use 'qp' for MQA/GQA"
            )


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]):
        if arch_id in REGISTRY:
            raise ValueError(f"duplicate arch id {arch_id}")
        REGISTRY[arch_id] = fn
        return fn

    return deco


def get_config(arch_id: str, **overrides) -> ModelConfig:
    # accept both dashes and underscores
    key = arch_id.replace("_", "-")
    aliases = {k.replace("_", "-"): k for k in REGISTRY}
    if key not in aliases:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(aliases)}")
    cfg = REGISTRY[aliases[key]]()
    if overrides:
        cfg = cfg.with_(**overrides)
    cfg.validate_style()
    return cfg


def list_archs() -> Tuple[str, ...]:
    return tuple(sorted(REGISTRY))


# ---------------------------------------------------------------------------
# reduced ("smoke") configs — same family & code paths, tiny sizes.
# ---------------------------------------------------------------------------

def reduce_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a config to CPU-smoke size while preserving its family,
    attention grouping ratio, FFN type, block style and special layers."""
    kv_ratio = max(cfg.n_kv_heads, 1) / max(cfg.n_heads, 1)
    n_heads = 4 if cfg.n_heads else 0
    n_kv = max(1, int(round(n_heads * kv_ratio))) if n_heads else 0
    if n_kv and n_heads % n_kv:
        n_kv = 2 if n_heads % 2 == 0 else 1
    small = dict(
        n_layers=4 if cfg.cross_attn_every else 2,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=16 if n_heads else 0,
        d_ff=96 if cfg.has_ffn else 0,
        vocab_size=128,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        n_experts=4 if cfg.n_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.n_experts else 0,
        ssm_state=8 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=8 if cfg.ssm_state else 256,
        cross_attn_every=2 if cfg.cross_attn_every else 0,
        n_vision_tokens=8 if cfg.cross_attn_every else 0,
        conv_pos_width=min(cfg.conv_pos_width, 5) if cfg.conv_pos_width else 0,
        dtype="float32",
        param_dtype="float32",
        name=cfg.name + "-smoke",
    )
    small.update(overrides)
    return cfg.with_(**small)
