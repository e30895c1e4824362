"""The benchmark harness's own CPU tests."""
