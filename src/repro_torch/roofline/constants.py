"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit)."""

PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12  # bytes/s of HBM3

BYTES = {
    "f32": 4,
    "bf16": 2,
    "f16": 2,
    "s32": 4,
    "u32": 4,
    "s8": 1,
    "u8": 1,
    "pred": 1,
    "s64": 8,
    "u64": 8,
    "f64": 8,
    "s16": 2,
    "u16": 2,
    "f8e4m3fn": 1,
    "f8e5m2": 1,
}
