"""Mean ``mb.complete`` span of the traced batches: the completion
thread's ``finalize_fn``, the wait for the batch's event and the copies
to the host."""
from perfbench.spans import durations_ms, mean, records


def read(rec):
    return mean(durations_ms(records(rec), "mb.complete"))
