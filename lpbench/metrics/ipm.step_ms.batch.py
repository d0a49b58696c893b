"""Synchronised wall time of each call's first ``run_batch`` (stage 1 with
its starting point) over the ``mehrotra_step`` calls inside it, ms a step
on average over the calls."""
from lpbench.metrics._read import mean


def read(records: dict):
    return mean(1e3 * c["run_batch_s"][0] / c["steps"][0]
                for c in records["calls"]
                if c.get("run_batch_s") and c["steps"][0])
