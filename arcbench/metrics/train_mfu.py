"""The model step's share of the card's bf16 peak: model FLOPs of a
token's forward and backward (from the configuration's sizes, remat
not counted) times the window's tokens per second, over 989 TFLOP/s."""

LAYER = "model step (train/step.py, models/model.py forward_train and autograd)"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "train_tokens_per_s"

PEAK_FLOPS = 989e12        # H100 SXM dense bf16 (NVIDIA data sheet)


def compute(r):
    if r.get("kind") != "train" or not r.get("tokens_per_s"):
        return None
    return 100.0 * r["flops_per_token"] * r["tokens_per_s"] / PEAK_FLOPS
