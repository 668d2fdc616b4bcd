"""Tokenizer front-end: the native C++ tokenizer only.

``get_tokenizer(num_threads)`` returns a callable
``(data, slices, params, geom, out=None) -> PictureTokens`` where ``slices``
is a list of ``(bit_pos_after_start_code, start_code)`` pairs and ``out``
optional tokens of the same geometry whose arrays are reused.  There is no Python
fallback: it would make a 1080p decode many times slower without saying so,
so a library that cannot be built or loaded raises instead.
"""
from __future__ import annotations

from .native import native_tokenizer


def get_tokenizer(num_threads: int = 0, on_error: str = "raise"):
    """``on_error``: "raise" aborts the decode on the first malformed slice;
    "drop_slice" contains the damage to the failing slice (its parsed prefix
    is kept, the count is reported via ``PictureTokens.bad_slices``)."""
    if on_error not in ("raise", "drop_slice"):
        raise ValueError(f"on_error must be 'raise' or 'drop_slice', "
                         f"not {on_error!r}")
    return native_tokenizer(num_threads, on_error)
