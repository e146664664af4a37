"""The share of the traced window in which no device operation ran."""

from benchmark_h100.harness.readings import idle_pct


def read(rec):
    return idle_pct(rec)
