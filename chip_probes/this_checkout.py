"""This checkout's ``chip_smoke.py``, loaded by path.

The probes that time another checkout put that checkout first on
``sys.path``; its ``chip_smoke.py`` may predate the helpers they use, so
they take this checkout's (which imports nothing of the package at
module level that the other checkout's would not provide).
"""

import importlib.util
import os

_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "chip_smoke.py")


def chip_smoke():
    spec = importlib.util.spec_from_file_location("this_chip_smoke", _PATH)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
