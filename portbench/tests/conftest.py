"""The benchmark's own tests: CPU tests at tiny sizes, and card tests
(marked ``cuda``) that skip where no card is present."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
