"""Architecture configuration: a copy of the JAX package's
``repro.configs.base`` (the shape presets left out).

``ArchConfig`` fully describes one of the assigned architectures.  Configs
are plain frozen dataclasses; CLI overrides are ``key=value`` strings
parsed by ``apply_overrides``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    shared_experts: int = 0
    router: str = "topk"  # topk | sigmoid | hash  (hash = BinomialHash routing)
    aux_loss_weight: float = 0.01
    capacity_factor: float = 1.25
    router_hash_omega: int = 16  # lookup iteration bound of the hash router
    # hash router only: which BULK_ENGINES lookup routes tokens (binomial is
    # the paper engine; jump selects the JumpHash device flavour)
    router_hash_engine: str = "binomial"
    # hash router only: route via the traced-n lookup (lookup_dyn),
    # so standalone/eager routing passes (placement studies, routing sweeps)
    # share one compiled router trace across expert counts. NOTE: inside a
    # jitted model step num_experts is still a static config field, so the
    # step itself retraces on resize regardless of this flag.
    router_dynamic_n: bool = False


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0  # 0 -> d_model
    conv_width: int = 4
    c: float = 8.0  # RG-LRU exponent scale


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # attention flavour
    attention: str = "gqa"  # gqa | mla | none
    qkv_bias: bool = False
    qk_norm: bool = False
    window: Optional[int] = None  # sliding-window size (None = full causal)
    pos_emb: str = "rope"  # rope | mrope | sinusoidal
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    mrope_sections: tuple[int, ...] = ()  # thirds of head_dim/2 for M-RoPE

    # norm / mlp flavour
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_bias: bool = False
    mlp: str = "swiglu"  # swiglu | gelu | geglu
    mlp_bias: bool = False

    # block schedule: pattern repeated to cover num_layers
    # entries: attn | rec | ssd ; moe_layer_start marks dense->moe switch
    pattern: tuple[str, ...] = ("attn",)
    moe: Optional[MoEConfig] = None
    moe_layer_start: int = 0
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None

    # io
    input_mode: str = "tokens"  # tokens | embeds | embeds_mrope
    tie_embeddings: bool = False
    mtp_depth: int = 0  # DeepSeek-V3 multi-token prediction depth

    # numerics / distribution
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: str = "full"  # none | full | dots
    fsdp: bool = False  # ZeRO-3 weight sharding along the data axis
    scan_layers: bool = True

    # sub-quadratic? (drives long_500k applicability)
    @property
    def subquadratic(self) -> bool:
        return self.window is not None or self.family in ("ssm", "hybrid")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so (vocab, d) params shard evenly
        on the 16-way model axis (standard MaxText-style vocab padding —
        padded classes are ordinary, never-targeted logits)."""
        if self.vocab_size % 256 == 0 or self.vocab_size < 4096:
            return self.vocab_size
        return (self.vocab_size + 255) // 256 * 256

    def layer_kinds(self) -> list[str]:
        """Expanded per-layer block kinds, honouring pattern + moe start."""
        kinds = []
        for i in range(self.num_layers):
            k = self.pattern[i % len(self.pattern)]
            if k == "attn" and self.moe is not None and i >= self.moe_layer_start:
                k = "attn_moe"
            kinds.append(k)
        return kinds


def apply_overrides(cfg: ArchConfig, overrides: list[str]) -> ArchConfig:
    """Apply ``key=value`` CLI overrides (ints/floats/bools auto-coerced)."""
    kv = {}
    fields = {f.name: f for f in dataclasses.fields(ArchConfig)}
    for ov in overrides:
        k, _, v = ov.partition("=")
        if k not in fields:
            raise KeyError(f"unknown config field '{k}'")
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            kv[k] = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            kv[k] = int(v)
        elif isinstance(cur, float):
            kv[k] = float(v)
        else:
            kv[k] = v
    return replace(cfg, **kv)
