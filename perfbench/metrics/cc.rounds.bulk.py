"""Mean ``cc.rounds`` count per traced engine call (the ``engine.run``
span's counts): the CC stitching's rounds, each begun by a host sync,
and one more sync to stop."""
from perfbench.spans import rounds


def read(rec):
    return rounds(rec)
