"""Arch registry: ``get(arch_id)`` -> ArchSpec; ``ARCHS`` lists all ids.

Every arch of the JAX package is registered, in its order: the five
transformer LM archs, the four GNN archs, the recsys arch and the engine.
"""

from repro_torch.configs.base import ARCHS, ArchSpec, ShapeSpec, get, register

# importing the arch modules populates the registry
from repro_torch.configs import (  # noqa: F401
    command_r_plus_104b,
    tinyllama_1_1b,
    gemma2_27b,
    kimi_k2_1t_a32b,
    olmoe_1b_7b,
    mace,
    graphcast,
    egnn,
    equiformer_v2,
    xdeepfm,
    k2triples,
)
