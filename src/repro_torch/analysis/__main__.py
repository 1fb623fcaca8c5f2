"""``python -m repro_torch.analysis``: the dispatch audit sweep."""
import sys

from .cli import main

sys.exit(main())
