"""Utilities of the port: phase timers and device profiling."""
