"""Utilities: device profiling."""
