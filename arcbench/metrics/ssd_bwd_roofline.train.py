"""The SSD gradient's least time (the copied ``ssd_bwd_bound_ms``) over
its seven kernels' device time in the trace."""

LAYER = "kernels/ssd_scan gradient"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def compute(r):
    if r.get("kind") != "train":
        return None
    ms = r.get("kernel_ms", {}).get("ssd_bwd")
    bound = r.get("bound_ms", {}).get("ssd_bwd")
    if not ms or not bound:
        return None
    return 100.0 * bound / ms
