"""Command-line entry points, run as ``python -m <package>.cli.<name>``."""
