"""Three-term roofline of one rank's step on an NVIDIA H100 (port of
``repro/roofline/analysis.py``, re-based on the H100).

Terms (seconds, per training/serving step, per card; the counts are one
rank's program, ``roofline/counts.py``):

    compute    = FLOPs_per_card / peak FLOP/s of the cell's compute dtype
    memory     = bytes_per_card / HBM bandwidth
    collective = sum over collectives of bytes_moved_per_card / link bandwidth

bytes_moved applies the ring multipliers (``ring_bytes``): all-gather and
all-to-all (n-1)/n, all-reduce 2(n-1)/n, reduce-scatter (n-1) of its
per-rank result, 1 for a point-to-point exchange or a broadcast (each rank
receives the tensor once), n the group's size.

How a mesh maps onto the machines: ranks are numbered row-major over the
mesh's axes (``init_device_mesh``), so the innermost axis ('model') is
contiguous, and an HGX node holds ``GPUS_PER_NODE`` = 8 consecutive ranks.
A group whose ranks all sit in one node talks over NVLink 4; a group that
spans nodes goes over the network (one 400 Gb/s InfiniBand NDR port per
GPU).  On the production 16 x 16 mesh a 'model' group of 16 spans two
nodes and a 'data' group sixteen, so every collective there is a network
one; a 'model' axis of at most 8 stays inside a node.

``model_flops`` uses the 6·N·D training rule (2·N·D inference) with N the
active parameters (MoE): the useful-compute yardstick beside the counted
FLOPs.
"""
from __future__ import annotations

import dataclasses

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates without sparsity,
# at the 700 W power limit).
H100_BYTES_PER_S = 3.35e12        # HBM3
H100_F32_FLOP_PER_S = 67e12       # f32 outside the tensor cores
H100_TF32_FLOP_PER_S = 495e12     # tensor cores, dense
H100_BF16_FLOP_PER_S = 989e12     # tensor cores, dense
# NVLink 4 inside an HGX H100 node: 900 GB/s per GPU both ways together,
# 450 GB/s one way (NVIDIA's HGX H100 data sheet).
NVLINK_BYTES_PER_S = 450e9
# Across nodes: one ConnectX-7 InfiniBand NDR port per GPU, 400 Gb/s.
NETWORK_BYTES_PER_S = 50e9
GPUS_PER_NODE = 8

# The compute term's peak by the cell's compute dtype.  float32 products
# run without TF32 (torch's default for matmuls), on the CUDA cores.
PEAK_FLOP_PER_S = {"bfloat16": H100_BF16_FLOP_PER_S, "float16": H100_BF16_FLOP_PER_S,
                   "float32": H100_F32_FLOP_PER_S}

# Bytes each collective moves per rank, by its result's bytes and the
# group's size n (ring algorithms).
RING_FACTOR = {"all-gather": lambda n: (n - 1) / n, "all-to-all": lambda n: (n - 1) / n,
         "all-reduce": lambda n: 2 * (n - 1) / n, "reduce-scatter": lambda n: n - 1,
         "exchange": lambda n: 1.0, "broadcast": lambda n: 1.0}


def ring_bytes(op: str, result_bytes: float, n: int) -> float:
    """Bytes one rank moves for a collective ``op`` whose result (on this
    rank) is ``result_bytes``, over a group of ``n`` ranks; 0 for n = 1."""
    if n <= 1:
        return 0.0
    return result_bytes * RING_FACTOR[op](n)


def spans_nodes(ranks) -> bool:
    """Whether a group of global ``ranks`` spans more than one node."""
    return len({r // GPUS_PER_NODE for r in ranks}) > 1


def bound(nbytes: float, nops: float, flop_per_s: float = H100_F32_FLOP_PER_S
          ) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card takes to move
    ``nbytes`` and do ``nops`` operations at ``flop_per_s``."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = nops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_accessed: float
    collective_bytes: float
    model_flops: float
    useful_ratio: float
    bottleneck: str
    step_s: float           # max of the three terms (overlap-ideal)
    roofline_frac: float    # model_flops_time / step_s  (the score)

    def to_dict(self):
        return dataclasses.asdict(self)


def analyse(cost: dict, collectives: dict, *, n_chips: int, model_flops_global: float,
            dtype: str = "bfloat16") -> Roofline:
    """The three terms of one card's step.  ``cost``: {"flops", "bytes
    accessed"}; ``collectives``: {"total_bytes"} and, where the recorder
    split them, {"by_link": {"nvlink": bytes, "network": bytes}} (without
    it every byte goes over the network).  ``dtype``: the cell's compute
    dtype, which picks the peak."""
    peak = PEAK_FLOP_PER_S[dtype]
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    cbytes = float(collectives["total_bytes"])
    links = collectives.get("by_link", {"network": cbytes})
    compute_s = flops / peak
    memory_s = bytes_acc / H100_BYTES_PER_S
    coll_s = (float(links.get("nvlink", 0.0)) / NVLINK_BYTES_PER_S
              + float(links.get("network", 0.0)) / NETWORK_BYTES_PER_S)
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    step_s = max(terms.values())
    mf_chip = model_flops_global / n_chips
    useful = mf_chip / flops if flops else 0.0
    ideal_s = mf_chip / peak
    frac = ideal_s / step_s if step_s else 0.0
    return Roofline(compute_s, memory_s, coll_s, flops, bytes_acc, cbytes,
                    mf_chip, useful, bottleneck, step_s, frac)


def model_flops(cfg, shape) -> float:
    """6·N_active·D for train, 2·N_active·D for inference, D = global tokens
    processed by the step (decode: batch tokens)."""
    n = cfg.active_param_count
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: one token/seq
