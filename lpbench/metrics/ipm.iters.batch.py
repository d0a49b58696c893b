"""``Solution.iterations`` an LP on average, every stage and rescue rung
included."""
from lpbench.metrics._read import iterations as read  # noqa: F401
