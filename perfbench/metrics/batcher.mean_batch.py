"""Mean size of the micro-batches ``MicroBatcher`` formed for the
window's requests (``stats["batches"][*]["n"]``)."""


def read(rec):
    b = rec["window"].stats.get("batches")
    return sum(n for n, _ in b) / len(b) if b else None
