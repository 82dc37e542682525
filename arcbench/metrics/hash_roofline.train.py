"""The integrity hash's least time (the copied ``bound_ms``, one row of a
grad leaf's lanes a call) over its kernels' device time in the trace."""

LAYER = "kernels/checksum"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def compute(r):
    if r.get("kind") != "train":
        return None
    ms = r.get("kernel_ms", {}).get("hash")
    bound = r.get("bound_ms", {}).get("hash")
    if not ms or not bound:
        return None
    return 100.0 * bound / ms
