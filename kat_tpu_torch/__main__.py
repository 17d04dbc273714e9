"""Allow `python -m kat_tpu_torch ...` as the kat command."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
