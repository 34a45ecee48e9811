"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit)."""

PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12  # bytes/s of HBM3
# NVLink 4 between the GPUs of one node: 900 GB/s per GPU in both directions
# together, 450e9 B/s each way.  An axis that crosses nodes (the "pod" axis,
# and a 16-wide "model" axis over 8-GPU nodes) runs on the network instead,
# so there this term is optimistic.
LINK_BW = 450e9  # bytes/s per direction

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
