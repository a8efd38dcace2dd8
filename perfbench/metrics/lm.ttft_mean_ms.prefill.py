"""Mean request latency over all requests of the window, send to first
token: every prompt length of the cycle weighs in, where the median sits
between the two middle lengths."""
import numpy as np


def read(rec):
    lat = rec["window"].latencies_s
    return float(np.mean(lat)) * 1e3 if lat else None
