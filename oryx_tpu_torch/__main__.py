"""``python -m oryx_tpu_torch``: the operator CLI (see deploy/main.py)."""

import sys

from .deploy.main import main

sys.exit(main())
