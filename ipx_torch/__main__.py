"""``python -m ipx_torch`` entry point."""
import sys

from ipx_torch.cli import main

sys.exit(main())
