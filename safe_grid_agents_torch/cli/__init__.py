"""Command line: ``python -m safe_grid_agents_torch <env> <agent> [flags]``."""
