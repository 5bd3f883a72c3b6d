"""Step functions and command-line entry points."""
