"""The flash forward's least time (the copied ``flash_bound_ms``, causal)
over its kernel's device time in the trace."""

LAYER = "kernels/flash_attention forward"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def compute(r):
    if r.get("kind") != "train":
        return None
    ms = r.get("kernel_ms", {}).get("flash_fwd")
    bound = r.get("bound_ms", {}).get("flash_fwd")
    if not ms or not bound:
        return None
    return 100.0 * bound / ms
