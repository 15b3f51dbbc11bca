"""moe_dropped_pct.docqa: the routed (token, expert) pairs that the
capacity dispatch dropped in the window's admissions, in % of those
routed: 100 x sum(pairs - kept) / sum(pairs) over the port's
``continuous.admit.stats`` spans."""
from portbench import readers


def read(ctx):
    args = [a for _, _, _, a in readers.spans(ctx, "continuous.admit.stats")
            if "pairs" in a]
    pairs = sum(a["pairs"] for a in args)
    if not pairs:
        return None
    return 100.0 * sum(a["pairs"] - a["kept"] for a in args) / pairs
