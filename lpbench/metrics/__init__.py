"""Readers of the metrics, one file each."""
