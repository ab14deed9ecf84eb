"""Command-line entry points (eval so far)."""
