"""Published peaks of the chips the benchmark runs on (NVIDIA's data
sheet, SXM part, dense rates without sparsity, at the full 700 W power
limit). A card set below that limit runs slower under load, so every
result line carries the card's name and `PERF.md` its power limit.

The configurations state float32. Their FLOPs are priced at the TF32
tensor-core rate, the fastest rate at which the card computes a float32
product; a share of it counts each FLOP once, whatever precision the
hardware uses (the port's InfoNCE kernels take three TF32 passes a
product, so they can reach a third of it)."""

H100 = {
    "flops_f32": 495e12,   # TF32 tensor cores, dense
    "bytes_per_s": 3.35e12,  # HBM3
}

PEAKS = {"H100": H100}


def peaks(kind: str):
    """The peaks of the card named `kind` (`torch.cuda.get_device_name`,
    e.g. "NVIDIA H100 80GB HBM3"), or None for a device the table does not
    hold, such as the CPU (then no share of a peak is reported)."""
    for family, table in PEAKS.items():
        if family in kind:
            return table
    return None
