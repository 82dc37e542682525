"""The SSD scan's least time over its kernels' device time in the
prefill cell, each scan at its batch's prompt length."""

LAYER = "kernels/ssd_scan forward"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "prefill_tokens_per_s"


def compute(r):
    if r.get("kind") != "prefill":
        return None
    ms = r.get("kernel_ms", {}).get("ssd_fwd")
    bound = r.get("bound_ms", {}).get("ssd_fwd")
    if not ms or not bound:
        return None
    return 100.0 * bound / ms
