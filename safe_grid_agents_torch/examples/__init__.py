"""Examples of the port's API, run as ``python -m
safe_grid_agents_torch.examples.<name>``."""
