"""Mean ``CostBook`` ``stage="postprocess"`` wall per image (the box
decode on the host) over the window."""


def read(rec):
    total, n = rec["window"].stats.get("book", {}).get("postprocess",
                                                       (0.0, 0))
    return total / n * 1e3 if n else None
