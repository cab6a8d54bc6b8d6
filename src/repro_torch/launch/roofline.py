"""Roofline terms of a dry-run count on the NVIDIA H100 SXM, and the
card's peaks: the one home of the H100 constants of the port.

Three terms per (arch x shape x mesh), in seconds a step:

    compute    = bf16 product flops / PEAK_BF16
                 + (f32 product flops + other flops) / PEAK_F32, a device
    memory     = bytes_naive a device / HBM_BW
    collective = NVLink wire bytes a device / NVLINK_BW
                 + network wire bytes a device / NETWORK_BW

The flops and bytes come from ``flopcount`` (the whole program, divided
by the chips; the reference's uniform-sharding assumption), the wire bytes
from ``dist.collectives.WIRE`` (ring factors: all-reduce ``2(g-1)/g``,
all-gather and reduce-scatter ``(g-1)/g``), split by the link each group
crosses: a group within one node of ``NODE_CARDS`` cards over NVLink, one
that spans nodes over the network (``collectives.link``).  Eager PyTorch fuses nothing,
so ``bytes_naive`` is the traffic the port really makes, not an upper
bound.  These are analytic bounds for the card, not measurements.

The constants (NVIDIA H100 SXM5 datasheet): HBM3 3.35 TB/s; 989 TFLOP/s
dense bf16 / f16 on the tensor cores; 67 TFLOP/s f32 on the CUDA cores
(the port's f32 products do not use TF32); 67 T/s of 32-bit integer or
logic operations (the k²-tree kernels' bit tests); NVLink 900 GB/s a card.
A node is a DGX H100 (NVIDIA DGX H100 user guide / SuperPOD reference
architecture): 8 cards on NVLink, and one ConnectX-7 NDR InfiniBand port
of 400 Gb/s a card to the network between nodes, 50 GB/s each way, so
100 GB/s on NVLINK_BW's convention (900 GB/s is NVLink 4's both
directions, 450 each way).
"""

from __future__ import annotations

import dataclasses

from repro_torch.dist.collectives import NODE_CARDS  # noqa: F401 (a node's cards)

HBM_BW = 3.35e12  # bytes/s
PEAK_BF16 = 989e12  # flop/s, dense, tensor cores
PEAK_F32 = 67e12  # flop/s, CUDA cores
PEAK_INT32 = 67e12  # 32-bit ops/s
NVLINK_BW = 900e9  # bytes/s a card, both directions
NETWORK_BW = 100e9  # bytes/s a card between nodes, both directions (one 400 Gb/s NDR port)


def bound_ms(bytes_: float, ops: float = 0.0, peak: float = PEAK_INT32) -> tuple[float, str]:
    """The least time the card takes for a function that must move
    ``bytes_`` and do ``ops`` operations at ``peak``: the larger of the two
    times, in ms, and which one it is ("bytes" or "operations")."""
    t_bytes = bytes_ / HBM_BW * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclasses.dataclass
class Roofline:
    name: str
    mesh: str
    chips: int
    flops_per_dev: float  # counted (flopcount), / chips
    bytes_per_dev: float  # flopcount's bytes_naive, / chips
    wire_bytes_per_dev: float  # dist.collectives.WIRE, / chips
    model_flops: float
    coll_detail: dict
    peak_mem_bytes: float = 0.0
    flops_bf16_per_dev: float = 0.0
    flops_f32_per_dev: float = 0.0
    link_detail: dict | None = None  # wire bytes a device by link; None: all over NVLink

    @property
    def t_compute(self) -> float:
        rest = self.flops_per_dev - self.flops_bf16_per_dev
        return self.flops_bf16_per_dev / PEAK_BF16 + rest / PEAK_F32

    @property
    def t_memory(self) -> float:
        return self.bytes_per_dev / HBM_BW

    @property
    def links(self) -> dict:
        """Wire bytes a device by link ("nvlink", "network")."""
        if self.link_detail is None:
            return {"nvlink": self.wire_bytes_per_dev, "network": 0.0}
        return dict(self.link_detail)

    @property
    def t_collective(self) -> float:
        by = self.links
        if not by["network"]:  # within a node: the whole count at NVLink's rate
            return self.wire_bytes_per_dev / NVLINK_BW
        return by["nvlink"] / NVLINK_BW + by["network"] / NETWORK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / (global program FLOPs): remat/redundancy waste."""
        total = self.flops_per_dev * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_frac(self) -> float:
        """Useful model FLOP/s at the bound step time vs the bf16 peak."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        if t <= 0:
            return 0.0
        return (self.model_flops / self.chips / t) / PEAK_BF16

    def to_dict(self) -> dict:
        return {
            "name": self.name, "mesh": self.mesh, "chips": self.chips,
            "flops_per_dev": self.flops_per_dev,
            "bytes_per_dev": self.bytes_per_dev,
            "wire_bytes_per_dev": self.wire_bytes_per_dev,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac,
            "peak_mem_bytes": self.peak_mem_bytes,
            "coll_detail": self.coll_detail,
            "link_detail": self.links,
            "flops_bf16_per_dev": self.flops_bf16_per_dev,
            "flops_f32_per_dev": self.flops_f32_per_dev,
        }


def analyze(name: str, mesh_name: str, chips: int, cost, wire: dict, model_flops: float,
            peak_mem_bytes: float = 0.0, links: dict | None = None) -> Roofline:
    """The :class:`Roofline` of a counted program (``flopcount.Cost``) and
    the wire bytes its collectives moved (``collectives.wire_bytes()``,
    summed over positions), by link where ``links``
    (``collectives.link_bytes()``) is given, else all over NVLink."""
    return Roofline(
        name=name, mesh=mesh_name, chips=chips,
        flops_per_dev=cost.flops / chips, bytes_per_dev=cost.bytes_naive / chips,
        wire_bytes_per_dev=sum(wire.values()) / chips, model_flops=model_flops,
        coll_detail={k: v / chips for k, v in wire.items()}, peak_mem_bytes=peak_mem_bytes,
        flops_bf16_per_dev=cost.flops_bf16 / chips, flops_f32_per_dev=cost.flops_f32 / chips,
        link_detail=None if links is None else {k: v / chips for k, v in links.items()},
    )


def fmt_row(r: Roofline) -> str:
    return (
        f"{r.name:42s} {r.mesh:9s} "
        f"c={r.t_compute*1e3:9.3f}ms m={r.t_memory*1e3:9.3f}ms "
        f"x={r.t_collective*1e3:9.3f}ms -> {r.bottleneck:10s} "
        f"useful={r.useful_flops_frac*100:5.1f}% roof={r.roofline_frac*100:5.1f}% "
        f"hbm={r.peak_mem_bytes/2**30:6.2f}G"
    )
