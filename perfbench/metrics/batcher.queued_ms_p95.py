"""95th percentile of how long the window's batches' oldest request
queued before dispatch (``stats["batches"][*]["queued_ms"]``)."""
import numpy as np


def read(rec):
    b = rec["window"].stats.get("batches")
    return float(np.percentile([q for _, q in b], 95)) if b else None
