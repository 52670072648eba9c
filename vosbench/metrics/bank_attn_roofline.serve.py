"""The inference bank attention's share of its roofline: in the traced
unit with the host's spans, the least time of every call (from its shapes,
counts/bank_attn_fwd at the bf16 peak and HBM bandwidth) over the device
time of the kernels launched inside the `bank_attention_infer` wrapper
(K1, K1ʰ and their merges). Layer: the kernels
(kernels/bank_attention.py, csrc/). Moves serve_fps."""

from vosbench.counts import bank_attn_fwd, bound_s, share

UNIT = "%"
SPAN = "vosbench.kernels.bank_attn"
SPANS = [("rmem_tpu_torch.kernels.bank_attention", "bank_attention_infer",
          SPAN)]


def read(ctx):
    tr = ctx.get("span_trace")
    calls = ctx["calls"].get(SPAN)
    if ctx["kind"] != "serve" or tr is None or not calls:
        return None
    dev_s = tr.span_device_s(SPAN)
    if not dev_s:
        return None
    least = 0.0
    for c in calls:
        b, lq, ck = c["q"]
        slots, _, lk, _ = c["bank_k"]
        cv = c["bank_v"][-1]
        least += bound_s(*bank_attn_fwd(b, lq, int(c["count"]), lk, ck, cv,
                                        slots, c["qbias"] is not None,
                                        c["num_heads"]))
    return share(least, dev_s)
