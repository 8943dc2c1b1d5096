"""Command-line entry points of the AL loop (seed round, AL rounds)."""
