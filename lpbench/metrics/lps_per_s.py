"""LPs that ended OPTIMAL and passed the reference, over the summed
seconds of the window's calls."""


def read(records: dict):
    return records["passed"] / records["seconds"]
