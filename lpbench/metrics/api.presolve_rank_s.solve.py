"""Seconds a call inside the program's span ``api.presolve.rank``:
presolve's pivoted QR and the consistency test of the rows it drops, from
the traced run's summaries (``program_spans``); None where the program has
no such span."""
from lpbench.program_spans import span_seconds


def read(records: dict):
    return span_seconds("api.presolve.rank")
