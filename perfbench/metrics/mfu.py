"""mfu: the model FLOPs that the work retired inside the window needed (each
emitted token's pass through every stage, causal attention included, and
its heads: ``flops.pass_flops``), over the window times the H100's dense
bf16 peak, in %."""

from perfbench.harness.flops import pass_flops
from perfbench.harness.peaks import PEAK_FLOPS_BF16


def read(rec):
    if not rec.tokens:
        return None
    total = 0.0
    for _, slot, rid, k in rec.tokens:
        L = rec.prompt_lens[slot][rid]
        total += pass_flops(rec.model, 0, L) if k == 0 else pass_flops(rec.model, L + k - 1, 1)
    return 100.0 * total / (rec.seconds * PEAK_FLOPS_BF16)
