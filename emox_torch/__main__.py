"""`python -m emox_torch <command>`: the port's command line (emox_torch.cli)."""

import sys

from emox_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
