"""Command-line tools of the port that are not the CLIs: microbenchmarks."""
