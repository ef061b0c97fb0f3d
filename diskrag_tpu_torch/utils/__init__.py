"""Utilities of the port: the span recorder and device profiling."""
