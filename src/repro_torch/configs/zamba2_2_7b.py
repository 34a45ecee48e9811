"""zamba2-2.7b [hybrid] — Mamba2 backbone with shared attention blocks.

[arXiv:2411.15242; hf]  54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64.  Layout: 5 Mamba2 blocks then one dense attention+FFN block,
repeated (the paper's "shared attention" inserted every ~6 blocks); 54 = 9
periods of 6.  Hybrid family -> runs long_500k (decode cost per step is
dominated by the SSM state; attention touches the KV cache linearly).

The port's copy of ``repro.configs.zamba2_2_7b``: its attention runs the
three attention kernels at head dim 80 (32 heads of 80, G 1).
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.ssm import MambaDims

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    norm="rmsnorm",
    act="silu",
    period=("mamba", "mamba", "mamba", "mamba", "mamba", "dense_attn"),
    mamba=MambaDims(d_model=2560, d_state=64, expand=2, head_dim=64, chunk=256),
    num_stages=4,
    exit_stages=(2, 3),
    sub_quadratic=True,
    notes="Mamba2 + periodic shared attn; SSM state cache carries long context",
)
