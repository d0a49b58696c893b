"""Summed bound over summed CUDA-event time of every call of the kernel
entries (``work/``), at 989 TFLOP/s and 3.35 TB/s, in percent."""
from lpbench.metrics._read import roofline as read  # noqa: F401
