import sys

from .controller import launch

sys.exit(launch())
