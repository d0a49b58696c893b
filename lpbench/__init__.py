"""The benchmark of ipx_torch (see BENCHMARK.json at the root)."""
