"""Tests of the benchmark harness (``python -m pytest -q perfbench/tests``)."""
