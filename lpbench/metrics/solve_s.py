"""The summed seconds of the window's calls over the LPs that ended
OPTIMAL and passed the reference: the wait for one LP's solution."""


def read(records: dict):
    return (records["seconds"] / records["passed"] if records["passed"]
            else None)
