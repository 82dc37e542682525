"""Host time of each ``save_async`` call in the window (the snapshot of the
state to the host), mean over the window's saves."""

LAYER = "checkpoint snapshot (checkpoint/manager.py save_async)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "ckpt_train_tokens_per_s"


def compute(r):
    ms = r.get("save_stall_ms")
    return sum(ms) / len(ms) if ms else None
