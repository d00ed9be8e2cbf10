"""``python -m surreal_tpu_torch``, the console entry (see ``main/launch.py``)."""

import sys

from surreal_tpu_torch.main.launch import main

sys.exit(main())
