"""95th percentile over the traced requests of their ``mb.form`` span:
submit to popped into a batch by ``MicroBatcher``."""
from perfbench.spans import durations_ms, p95, records


def read(rec):
    return p95(durations_ms(records(rec), "mb.form"))
