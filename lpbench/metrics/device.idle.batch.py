"""1 - the union of the device's activity intervals over the entry's calls'
time, from the profiler's trace, in percent."""
from lpbench.metrics._read import idle as read  # noqa: F401
