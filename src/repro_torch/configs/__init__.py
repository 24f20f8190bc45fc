"""Config registry: the 10 assigned architectures + the paper benchmark
config, copied from the JAX package's ``repro.configs``.  The port's model
runs the ``attn`` and ``attn_moe`` blocks of the GQA architectures; the
others stay as data (``repro_torch.models`` raises on what it lacks)."""
from __future__ import annotations

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    MLAConfig,
    MoEConfig,
    RGLRUConfig,
    SSMConfig,
    apply_overrides,
)

# -- dense LM family --------------------------------------------------------

DEEPSEEK_CODER_33B = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=100000.0,
    norm="rmsnorm",
    mlp="swiglu",
)

STARCODER2_7B = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    window=4096,  # sliding-window attention (arXiv:2402.19173)
    norm="layernorm",
    norm_bias=True,
    mlp="gelu",
    mlp_bias=True,
    qkv_bias=True,
)

QWEN2_5_14B = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    norm="rmsnorm",
    mlp="swiglu",
)

STABLELM_3B = ArchConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    rope_fraction=0.25,
    norm="layernorm",
    mlp="swiglu",
)

# -- MoE family --------------------------------------------------------------

DEEPSEEK_V3_671B = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=18432,  # dense layers
    vocab_size=129280,
    attention="mla",
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        d_ff_expert=2048,
        shared_experts=1,
        router="sigmoid",
    ),
    moe_layer_start=3,  # first 3 layers dense
    mtp_depth=1,
    fsdp=True,
)

QWEN3_MOE_235B = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=12288,  # (unused: all layers MoE)
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536, router="topk"),
    moe_layer_start=0,
    fsdp=True,
)

# -- hybrid / SSM ------------------------------------------------------------

RECURRENTGEMMA_9B = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    window=2048,  # local attention layers
    pattern=("rec", "rec", "attn"),
    rglru=RGLRUConfig(lru_width=4096, conv_width=4),
    mlp="geglu",
    norm="rmsnorm",
)

MAMBA2_1_3B = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    attention="none",
    pattern=("ssd",),
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1, conv_width=4, chunk=256),
    tie_embeddings=True,
)

# -- modality backbones (frontends stubbed; see DESIGN.md §5) -----------------

MUSICGEN_MEDIUM = ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    input_mode="embeds",  # EnCodec frame embeddings provided by the stub
    pos_emb="sinusoidal",
    norm="layernorm",
    norm_bias=True,
    mlp="gelu",
)

QWEN2_VL_7B = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    input_mode="embeds_mrope",  # patch/text embeddings provided by the stub
    pos_emb="mrope",
    mrope_sections=(16, 24, 24),
    qkv_bias=True,
    rope_theta=1000000.0,
    norm="rmsnorm",
    mlp="swiglu",
)

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in [
        DEEPSEEK_CODER_33B,
        STARCODER2_7B,
        QWEN2_5_14B,
        STABLELM_3B,
        DEEPSEEK_V3_671B,
        QWEN3_MOE_235B,
        RECURRENTGEMMA_9B,
        MAMBA2_1_3B,
        MUSICGEN_MEDIUM,
        QWEN2_VL_7B,
    ]
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(name: str) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests (per assignment rules)."""
    import dataclasses

    cfg = get_config(name)
    kw: dict = dict(
        num_layers=max(2, len(cfg.pattern)) if len(cfg.pattern) > 1 else 2,
        d_model=64,
        vocab_size=256,
        dtype="float32",
        param_dtype="float32",
        remat="none",
    )
    if cfg.attention != "none":
        kw.update(num_heads=4, num_kv_heads=max(1, min(cfg.num_kv_heads, 2)), head_dim=16)
        if cfg.num_kv_heads == cfg.num_heads:
            kw.update(num_kv_heads=4)  # keep the MHA family trait
    if cfg.d_ff:
        kw.update(d_ff=128)
    if cfg.moe is not None:
        # capacity_factor 8 -> no token dropping, so cached decode is exactly
        # consistent with the full forward in the tiny smoke regime
        kw.update(
            moe=dataclasses.replace(
                cfg.moe, num_experts=8, top_k=2, d_ff_expert=32, capacity_factor=8.0
            )
        )
        kw.update(moe_layer_start=min(cfg.moe_layer_start, 1), num_layers=3)
    if cfg.mla is not None:
        kw.update(
            mla=MLAConfig(
                q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
                v_head_dim=16,
            )
        )
    if cfg.ssm is not None:
        kw.update(ssm=dataclasses.replace(cfg.ssm, d_state=16, head_dim=8, chunk=8))
    if cfg.rglru is not None:
        kw.update(rglru=dataclasses.replace(cfg.rglru, lru_width=64), num_layers=len(cfg.pattern) + 2)
    if cfg.window is not None:
        kw.update(window=16)
    if cfg.mrope_sections:
        kw.update(mrope_sections=(4, 2, 2))
    kw.update(fsdp=False, mtp_depth=cfg.mtp_depth)
    return dataclasses.replace(cfg, **kw)


# The paper's own benchmark "config": cluster sizes for the hashing suite.
PAPER_BENCH = {
    "cluster_sizes": [10, 100, 1000, 10_000, 100_000],
    "keys_per_node": 1000,
    "omega": 64,
}
