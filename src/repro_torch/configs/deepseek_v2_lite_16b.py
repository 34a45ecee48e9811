"""deepseek-v2-lite-16b [moe] — MLA + fine-grained MoE.

[arXiv:2405.04434; hf]  27L d_model=2048 16H (MLA kv_lora=512) expert
d_ff=1408 vocab=102400; 64 routed experts top-6 + 2 shared experts.
(The HF checkpoint keeps layer 0 dense; as in the JAX package's config,
all 27 layers are modelled as MoE.)  MLA is compressed-KV but still a full
softmax over the cache.
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import MlaDims
from repro_torch.models.moe import MoeDims

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    head_dim=128,
    norm="rmsnorm",
    act="silu",
    rope_theta=1e4,
    period=("moe_attn",),
    mla=MlaDims(
        d_model=2048,
        num_heads=16,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoeDims(
        d_model=2048,
        d_ff_expert=1408,
        num_experts=64,
        top_k=6,
        num_shared=2,
        router_norm="softmax_topk",
    ),
    num_stages=4,
    exit_stages=(2, 3),
    sub_quadratic=False,
)
