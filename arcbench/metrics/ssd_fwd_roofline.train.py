"""The SSD scan's least time (the copied ``ssd_bound_ms`` at the cell's
shape, times the scans the counters saw) over its kernels' device time
in the trace, in a train cell (forward and remat)."""

LAYER = "kernels/ssd_scan forward"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def compute(r):
    if r.get("kind") != "train":
        return None
    ms = r.get("kernel_ms", {}).get("ssd_fwd")
    bound = r.get("bound_ms", {}).get("ssd_fwd")
    if not ms or not bound:
        return None
    return 100.0 * bound / ms
