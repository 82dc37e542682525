"""The share of the traced window in which no operation ran on the card
(``torch.profiler``'s device activity), in the prefill cell."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "prefill_tokens_per_s"


def compute(r):
    if r.get("kind") != "prefill" or not r.get("window_s"):
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])
