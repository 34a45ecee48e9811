"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit): a frozen copy of
``repro_torch.roofline.constants`` and of the figures ``chip_smoke.py``
prints its bounds against."""

PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12  # bytes/s of HBM3
