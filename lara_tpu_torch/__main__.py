from lara_tpu_torch.cli import main
import sys

sys.exit(main())
