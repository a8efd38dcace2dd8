"""Share of the traced slice in which no device activity ran."""
from perfbench.trace import idle_pct


def read(rec):
    return idle_pct(rec["trace"])
