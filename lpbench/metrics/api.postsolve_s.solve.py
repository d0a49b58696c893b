"""Seconds a call inside the program's span ``api.postsolve``: everything
after the reduced solve returns (unscaling, the primal and dual polish,
the contract's check in the user's units, a continued solve where one is
needed), from the traced run's summaries (``program_spans``); None where
the program has no such span."""
from lpbench.program_spans import span_seconds


def read(records: dict):
    return span_seconds("api.postsolve")
