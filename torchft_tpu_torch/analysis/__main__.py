"""``python -m torchft_tpu_torch.analysis`` — the tft-lint entry point."""

import sys

from torchft_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
