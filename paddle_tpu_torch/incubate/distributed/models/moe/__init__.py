"""The expert-parallel MoE layer (port of paddle_tpu/incubate/distributed/
models/moe): the gates, `MoELayer` with its stacked `ExpertFFN` split
over mp, and the MoE-aware global-norm clip."""
from .moe_layer import MoELayer, ExpertFFN  # noqa: F401
from .gate import BaseGate, NaiveGate, GShardGate, SwitchGate  # noqa: F401
from .grad_clip import ClipGradForMOEByGlobalNorm  # noqa: F401
