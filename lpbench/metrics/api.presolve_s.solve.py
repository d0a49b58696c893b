"""Seconds a call inside the program's span ``api.presolve``: the whole of
presolve (the reductions, Ruiz and the cost scaling, the dependent-row
QR), from the traced run's summaries (``program_spans``); None where the
program has no such span."""
from lpbench.program_spans import span_seconds


def read(records: dict):
    return span_seconds("api.presolve")
