"""Utilities: device choice, block timing and traces, plot analysis, tempo."""
