"""The 95th percentile, over every request sent in the window that got a
first token, of its first-token time less its send time (linear
interpolation between order statistics)."""
import numpy as np


def read(record):
    t = [r["ttft_s"] for r in record["requests"] if r["ttft_s"] is not None]
    return float(np.percentile(t, 95)) * 1e3 if t else None
