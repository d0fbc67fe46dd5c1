"""CLI entry point: ``python -m repro_torch.plan`` (see planner/cli.py)."""
import sys

from .planner.cli import main

if __name__ == "__main__":
    sys.exit(main())
