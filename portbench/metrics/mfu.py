"""The whole step's share of the card's bf16 peak over the traced window:
2 x active parameters x (prompt tokens computed + tokens generated), over
the window's seconds x 989 TFLOP/s."""
from portbench.roofline import PEAK_BF16_FLOPS


def read(record):
    work = record["engine"]["prefill_tokens"] + record["tokens"]
    if not work:
        return None
    return 100.0 * 2 * record["active_params"] * work / (
        record["window_s"] * PEAK_BF16_FLOPS)
