"""Seconds from the start of ``run.py`` to the first timed call: imports,
the port's kernels loaded (built on a checkout's first run), the
warm-up."""


def read(records: dict):
    return records["setup_s"]
