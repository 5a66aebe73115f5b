"""Roofline terms of a dry-run cell (port of ``repro.launch.roofline``).

Hardware model: NVIDIA H100 SXM5 80GB at its 700 W power limit, from the
card's data sheet (not measured):

    PEAK_FLOPS = 989 TFLOP/s  dense bf16 on the tensor cores
    HBM_BW     = 3.35 TB/s    HBM3
    LINK_BW    = 50 GB/s      a GPU's share of the scale-out network: one
                              400 Gb/s NIC per GPU

Both 16-wide axes of the production mesh span more than one 8-GPU node,
so every collective of a cell is priced at the scale-out rate; NVLink's
450 GB/s a direction is the intra-node figure, which no production-mesh
axis stays inside.  One compute peak is kept, as the reference keeps
one: int8's 1979 TOP/s would halve the compute term of the int8-wire
products.

Terms (per step, in seconds, each of one rank's program):

    compute    = flops / PEAK_FLOPS
    memory     = bytes_hbm / HBM_BW
    collective = bytes_collective / LINK_BW

The counts come from the dry-run's counting modes on one rank's shards
(``launch/dryrun.py``), not from parsed HLO: the flops of every local
aten op, each op's operand and result bytes (an unfused eager count, not
XLA's fused one), and each collective's result bytes.
"""

from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12  # dense bf16 FLOP/s, H100 SXM5 data sheet
HBM_BW = 3.35e12  # bytes/s, H100 SXM5 HBM3 data sheet
LINK_BW = 50e9  # bytes/s a GPU: one 400 Gb/s NIC (NVLink: 450e9 a direction, intra-node)

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


@dataclasses.dataclass
class Roofline:
    flops: float  # per device
    bytes_hbm: float  # per device
    bytes_collective: float  # per device
    coll_breakdown: dict
    coll_counts: dict

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.bytes_collective / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self):
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_hbm,
            "collective_bytes_per_device": self.bytes_collective,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "coll_breakdown": self.coll_breakdown,
            "coll_counts": self.coll_counts,
        }


def analyze(counts) -> Roofline:
    """A :class:`Roofline` from one trace's counts: anything with
    ``flops``, ``bytes_hbm``, ``coll_bytes`` and ``coll_counts`` (the
    last two dicts keyed by :data:`COLLECTIVES`), as
    ``dryrun.Counts`` has them."""
    coll = {k: float(counts.coll_bytes.get(k, 0)) for k in COLLECTIVES}
    return Roofline(
        flops=float(counts.flops),
        bytes_hbm=float(counts.bytes_hbm),
        bytes_collective=float(sum(coll.values())),
        coll_breakdown=coll,
        coll_counts={k: int(counts.coll_counts.get(k, 0)) for k in COLLECTIVES},
    )


def model_flops(cfg, cell) -> float:
    """MODEL_FLOPS convention: 6·N·D train, 2·N·D prefill, 2·N·B decode
    (N = active params for MoE)."""
    n = cfg.active_param_count()
    if cell.kind == "train":
        return 6.0 * n * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n * cell.global_batch * cell.seq_len
    return 2.0 * n * cell.global_batch  # decode: one token per sequence
