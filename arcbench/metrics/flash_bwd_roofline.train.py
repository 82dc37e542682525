"""The flash backward's least time (the copied ``flash_bwd_bound_ms``)
over its three kernels' device time in the trace."""

LAYER = "kernels/flash_attention backward"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def compute(r):
    if r.get("kind") != "train":
        return None
    ms = r.get("kernel_ms", {}).get("flash_bwd")
    bound = r.get("bound_ms", {}).get("flash_bwd")
    if not ms or not bound:
        return None
    return 100.0 * bound / ms
