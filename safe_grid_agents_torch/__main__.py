"""``python -m safe_grid_agents_torch <env> <agent> [flags]`` — mirrors the
reference's ``python main.py <env> <agent> [flags]`` surface."""
from .cli.main import main

main()
