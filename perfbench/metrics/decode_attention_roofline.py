"""decode_attention_roofline: in the traced span, the least time the chip could take
for every ``kernels.ops.decode_attention`` call (the larger of its FLOPs over the
bf16 peak and its bytes over HBM's rate, from its shapes: ``flops.py``),
over the device time of the kernels those calls launched, in %."""


def read(rec):
    t = rec.trace
    if t is None or not t["calls"]["decode_attention"] or t["op_device_s"]["decode_attention"] <= 0:
        return None
    return 100.0 * t["least_s"]["decode_attention"] / t["op_device_s"]["decode_attention"]
