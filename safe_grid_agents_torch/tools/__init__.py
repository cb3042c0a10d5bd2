"""Measurement scripts of the port, run as ``python -m
safe_grid_agents_torch.tools.<name>`` on a machine with a card."""
