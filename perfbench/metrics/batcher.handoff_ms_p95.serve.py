"""95th percentile over the traced batches of their ``mb.handoff`` span:
popped into a batch to picked up by the dispatch thread."""
from perfbench.spans import durations_ms, p95, records


def read(rec):
    return p95(durations_ms(records(rec), "mb.handoff"))
