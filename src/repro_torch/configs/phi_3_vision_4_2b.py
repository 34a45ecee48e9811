"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (stubbed).

[hf:microsoft/Phi-3-vision-128k-instruct; hf]  32L d_model=3072 32H (GQA
kv=32 == MHA) d_ff=8192 vocab=32064.  The vision tower is a modality
frontend STUB: ``input_specs()`` hands the backbone precomputed patch
embeddings of shape [B, S, d_model] (assignment rules).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    norm="rmsnorm",
    act="silu",
    ffn="glu",
    rope_theta=1e4,
    period=("attn",),
    frontend="embeds",
    num_stages=4,
    exit_stages=(2, 3),
    sub_quadratic=False,  # pure full attention -> long_500k skipped
    notes="vision frontend stubbed as precomputed patch embeddings",
)
