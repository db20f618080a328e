import sys

from quant_tpu_torch.cli import main

sys.exit(main())
