"""Command-line entry points (run with ``python -m``)."""
