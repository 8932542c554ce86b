"""Top-k linear gate (port of paddle_tpu/incubate/distributed/models/moe/
gate/naive_gate.py): linear scores and their top k, no capacity."""
from __future__ import annotations

import torch

from ......nn.layers import Linear
from .base_gate import BaseGate


class NaiveGate(BaseGate):
    def __init__(self, d_model, num_expert, world_size, topk=2, *,
                 device=None, dtype=torch.float32):
        super().__init__(num_expert, world_size)
        self.gate = Linear(d_model, self.tot_expert, device=device,
                           dtype=dtype)
        self.top_k = topk

    def forward(self, inp, return_all_scores=False):
        gate = self.gate(inp)
        gate_top_k_val, gate_top_k_idx = torch.topk(gate, self.top_k,
                                                    dim=-1, largest=True)
        if return_all_scores:
            return gate_top_k_val, gate_top_k_idx, gate
        return gate_top_k_val, gate_top_k_idx
