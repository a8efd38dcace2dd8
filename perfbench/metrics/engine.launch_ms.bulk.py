"""Mean per traced engine call of its ``engine.run`` span less the
``cc.sync`` spans beneath it: host time spent launching."""
from perfbench.spans import launch_ms


def read(rec):
    return launch_ms(rec)
