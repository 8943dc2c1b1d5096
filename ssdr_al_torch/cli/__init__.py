"""Command-line entry points: the seed round, AL rounds and the standalone
evaluation."""
