"""Inputs made from ``--seed``: the same seed gives the same numbers.

Every stream of numbers has a seed of its own, derived from the run's
seed and a tag, so that a reference can make one stream again (one
layer's cache rows, say) without making the others.  Large tensors are
drawn on the device by a ``torch.Generator`` there, in a few large calls.
"""
from __future__ import annotations

import hashlib

CHUNK = 1 << 28          # elements drawn by one call


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for the stream ``tags`` of run ``seed``."""
    text = ":".join([str(int(seed))] + [str(t) for t in tags])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def generator(torch, device, seed: int, *tags):
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, *tags))
    return gen


def normal(torch, n: int, dtype, device, seed: int, *tags):
    """``n`` draws of N(0, 1) as a flat tensor of ``dtype``."""
    gen = generator(torch, device, seed, *tags)
    flat = torch.empty(n, dtype=dtype, device=device)
    for lo in range(0, n, CHUNK):
        flat[lo:lo + CHUNK].normal_(generator=gen)
    return flat


def carve(flat, shapes: list) -> list:
    """Contiguous views of ``flat``, one per shape, in order."""
    out, lo = [], 0
    for shape in shapes:
        n = 1
        for s in shape:
            n *= s
        out.append(flat[lo:lo + n].view(shape))
        lo += n
    return out
