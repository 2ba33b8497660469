"""The whole decode step's share of the card's f32 peak: model FLOPs of
every token the steps of the bare first third processed (fed prompt
tokens and generated ones, at their context lengths; the benchmark's own
formula over the published sizes) over that third's seconds, over 67
TFLOP/s (f32 outside the tensor cores, the configuration's arithmetic)."""
from perfbench.roofline import H100_F32_FLOP_PER_S


def read(sources):
    c = (sources.get("counts") or {}).get("bare")
    if not c or c["seconds"] <= 0 or c["flops"] <= 0:
        return None
    return 100.0 * c["flops"] / c["seconds"] / H100_F32_FLOP_PER_S
