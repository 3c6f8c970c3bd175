"""Scatter-min index streams shaped like the rLap endpoint stream's hubs,
shared by `test_torch_access.py` (CPU, against `jax.numpy`) and
`test_torch_kernels.py` (the card, against the plain version). It holds
no tests itself, and imports no JAX, so that the card's machine can run
the second file alone."""

import numpy as np
import torch

SIZE = 3000  # table entries
# name -> (E, longest run); runs of one index in ascending order, as the
# sender-sorted pool gives them
STREAMS = {
    "runs_to_3000": (20011, 3000),
    "e_not_multiple_of_4": (4097, 300),
    "e_below_32": (19, 5),
    "all_equal": (5001, None),
    "odd_offset_view": (9001, 2000),
}


def hub_stream(name: str, device="cpu", seed: int = 0):
    """(idx, val) int32 of stream `name` on `device`. "odd_offset_view"
    gives views one element into their storage, both at the same offset
    from a 16-byte boundary."""
    e, longest = STREAMS[name]
    r = np.random.default_rng(seed)
    if longest is None:
        idx = np.full(e, 7)
    else:
        lengths = r.integers(1, longest + 1, e)
        lengths = lengths[:np.searchsorted(np.cumsum(lengths), e) + 1]
        keys = np.sort(r.integers(0, SIZE, lengths.size))
        idx = np.repeat(keys, lengths)[:e]
    val = r.integers(0, 1 << 20, e)
    skip = 1 if name == "odd_offset_view" else 0
    out = []
    for a in (idx, val):
        t = torch.zeros(e + skip, dtype=torch.int32, device=device)
        t[skip:] = torch.from_numpy(a.astype(np.int32)).to(device)
        out.append(t[skip:])
    return tuple(out)
