"""xlstm-350m [ssm] — alternating mLSTM / sLSTM blocks.

[arXiv:2405.04517; unverified]  24L d_model=1024 4H d_ff=0 vocab=50304.
xLSTM blocks carry their own up/down projections (d_ff=0: no separate FFN).
Pure recurrent state -> long_500k runs (O(1) state per decode step).

The port's copy of ``repro.configs.xlstm_350m``: no attention, so of the
kernels only the exit head runs.
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.ssm import XlstmDims

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    norm="rmsnorm",
    act="silu",
    period=("mlstm", "slstm"),
    xlstm=XlstmDims(d_model=1024, num_heads=4, expand=2, chunk=256),
    num_stages=4,
    exit_stages=(2, 3),
    sub_quadratic=True,
)
