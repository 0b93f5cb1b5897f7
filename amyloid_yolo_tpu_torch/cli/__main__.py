"""``python -m amyloid_yolo_tpu_torch.cli <command> ...``"""

import sys

from .main import main

sys.exit(main())
