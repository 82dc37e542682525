"""The serving step's share of the card's bf16 peak: forward FLOPs of a
prompt token times the window's prompt tokens per second, over 989
TFLOP/s."""

LAYER = "serving step (launch/serve.py generate, models/model.py serve_step)"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "prefill_tokens_per_s"

PEAK_FLOPS = 989e12        # H100 SXM dense bf16 (NVIDIA data sheet)


def compute(r):
    if r.get("kind") != "prefill" or not r.get("tokens_per_s"):
        return None
    return 100.0 * r["flops_per_token"] * r["tokens_per_s"] / PEAK_FLOPS
