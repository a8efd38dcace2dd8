"""Mean ``CostBook`` ``stage="step"`` wall (dispatch through the copy of
the results to the host) of the window's engine steps."""


def read(rec):
    total, n = rec["window"].stats.get("book", {}).get("step", (0.0, 0))
    return total / n * 1e3 if n else None
