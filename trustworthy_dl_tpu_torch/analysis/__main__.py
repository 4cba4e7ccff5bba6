"""``python -m trustworthy_dl_tpu_torch.analysis``, the same as the
``trustworthy-dl-torch-lint`` console script."""

import sys

from trustworthy_dl_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
