"""Multi-process launcher (port of paddle_tpu/distributed/launch; reference:
python/paddle/distributed/launch/): ``python -m
paddle_tpu_torch.distributed.launch --nproc_per_node N script.py``."""
from .context import Context  # noqa: F401
from .controller import CollectiveController, launch  # noqa: F401
