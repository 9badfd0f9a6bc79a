"""Ray-chunk evaluation (port of envgs_tpu/utils/chunk.py, the reference's
`chunkify` decorator): the leading P axis split into chunks of
`chunk_size`, the last one zero-padded to the full size (every call sees
one shape, as the JAX package's `lax.map` does), the chunks run in turn and
their outputs concatenated along axis 0 and cropped to P. Outputs may be
tensors, or tuples / lists / dicts of them."""
from __future__ import annotations

import functools

import torch


def _merge(outs: list, P: int):
    first = outs[0]
    if isinstance(first, dict):
        return {k: _merge([o[k] for o in outs], P) for k in first}
    if isinstance(first, (tuple, list)):
        merged = [_merge([o[i] for o in outs], P) for i in range(len(first))]
        return type(first)(*merged) if hasattr(first, "_fields") else type(
            first)(merged)
    return torch.cat(outs, dim=0)[:P]


def chunkify(chunk_size: int = 65536):
    """Decorator: fn(rays (P, ...), *consts) -> outputs with a leading P
    axis becomes memory-bounded chunked evaluation; the other positional
    arguments are passed whole to every chunk."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(rays, *consts):
            P = rays.shape[0]
            n = -(-P // chunk_size)
            pad = n * chunk_size - P
            rp = torch.cat([rays, rays.new_zeros((pad, *rays.shape[1:]))])
            return _merge([fn(rp[i * chunk_size:(i + 1) * chunk_size],
                              *consts) for i in range(n)], P)

        return run

    return wrap
