"""Arch registry: ``get(arch_id)`` -> ArchSpec; ``ARCHS`` lists all ids.

Only the engine family is registered; the LM, GNN and recsys archs come
with their models."""

from repro_torch.configs.base import ARCHS, ArchSpec, ShapeSpec, get, register

# importing the arch modules populates the registry
from repro_torch.configs import k2triples  # noqa: F401
