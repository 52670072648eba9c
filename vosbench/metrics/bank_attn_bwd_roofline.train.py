"""The bank attention backward's share of its roofline: in the traced unit
with the host's spans, the least time of every call (from its shapes,
counts/bank_attn_bwd) over the device time of the kernels launched inside
the backward wrappers (`bank_attention_bwd`: K2; `bank_attention_bwd_mh`:
K2ʰ at 8 heads). Layer: the kernels. Moves train_clips_per_s."""

from vosbench.counts import bank_attn_bwd, bound_s, share

UNIT = "%"
SPAN = "vosbench.kernels.bank_attn_bwd"
KB = "rmem_tpu_torch.kernels.bank_attention"
SPANS = [(KB, "bank_attention_bwd", SPAN), (KB, "bank_attention_bwd_mh", SPAN)]


def read(ctx):
    tr = ctx.get("span_trace")
    calls = ctx["calls"].get(SPAN)
    if ctx["kind"] != "train" or tr is None or not calls:
        return None
    dev_s = tr.span_device_s(SPAN)
    if not dev_s:
        return None
    least = 0.0
    for c in calls:
        b, lq, ck = c["q"]
        slots, _, lk, _ = c["bank_k"]
        cv = c["bank_v"][-1]
        # bank_attention_bwd_mh takes no num_heads: each head's lse is
        # [B, heads, Lq]
        heads = c["num_heads"] if "num_heads" in c else c["lse_h"][1]
        least += bound_s(*bank_attn_bwd(b, lq, int(c["count"]), lk, ck, cv,
                                        slots, heads))
    return share(least, dev_s)
