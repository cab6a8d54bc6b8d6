"""Arch registry: ``get(arch_id)`` -> ArchSpec; ``ARCHS`` lists all ids.

The engine family and the five transformer LM archs are registered, in
the JAX package's order; the GNN and recsys archs come with their models.
"""

from repro_torch.configs.base import ARCHS, ArchSpec, ShapeSpec, get, register

# importing the arch modules populates the registry
from repro_torch.configs import (  # noqa: F401
    command_r_plus_104b,
    tinyllama_1_1b,
    gemma2_27b,
    kimi_k2_1t_a32b,
    olmoe_1b_7b,
    k2triples,
)
