"""Median request latency over all requests of the window: from due (an
open loop's schedule; the send in a closed loop) to boxes on the host."""
import numpy as np


def read(rec):
    lat = rec["window"].latencies_s
    return float(np.median(lat)) * 1e3 if lat else None
