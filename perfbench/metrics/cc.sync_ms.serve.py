"""Mean per traced engine call of its summed ``cc.sync`` spans: the CC
rounds' convergence reads, host time blocked on the device."""
from perfbench.spans import sync_ms


def read(rec):
    return sync_ms(rec)
