"""Solver status codes (same values as ``ipx.status``)."""
from __future__ import annotations

import enum


class Status(enum.IntEnum):
    RUNNING = 0
    OPTIMAL = 1
    MAX_ITER = 2
    NUMERICAL_FAILURE = 3
    # Heuristic, divergence-based certificates.
    PRIMAL_INFEASIBLE = 4
    DUAL_INFEASIBLE = 5
    # mu hit the dtype floor, or stopped shrinking, before all tolerances
    # were met; the best iterate visited is reported.
    STALLED = 6


STATUS_NAMES = {int(s): s.name for s in Status}
