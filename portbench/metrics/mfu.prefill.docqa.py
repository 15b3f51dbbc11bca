"""mfu.prefill.docqa: prefill FLOPs of the prompts admitted in the window over
the summed durations of their ``continuous.admit`` spans times the bf16
peak, in %."""
from portbench import readers, roofline


def read(ctx):
    spans = readers.spans(ctx, "continuous.admit")
    flops = sum(roofline.prefill_flops(ctx.spec, a["S"]) * a["rows"]
                for _, _, _, a in spans)
    took = sum(e - s for _, s, e, _ in spans)
    return readers.share(flops / roofline.PEAK_BF16_FLOPS, took)
