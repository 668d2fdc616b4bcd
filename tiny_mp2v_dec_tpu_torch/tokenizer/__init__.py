"""Tokenizer front-end: the native C++ tokenizer for the decoder.

``get_tokenizer(num_threads)`` returns a callable
``(data, slices, params, geom, out=None) -> PictureTokens`` where ``slices``
is a list of ``(bit_pos_after_start_code, start_code)`` pairs and ``out``
optional tokens of the same geometry whose arrays are reused.  There is no Python
fallback: it would make a 1080p decode many times slower without saying so,
so a library that cannot be built or loaded raises instead.

``python_tokenizer(on_error)`` returns the same callable (without ``out``)
over the pure-Python tokenizer (:mod:`.python_tok`, which the golden model
calls itself), for callers that ask for it by name: it is no decoder
option.
"""
from __future__ import annotations

from .native import native_tokenizer
from .types import PictureTokens


def _check_on_error(on_error: str) -> None:
    if on_error not in ("raise", "drop_slice"):
        raise ValueError(f"on_error must be 'raise' or 'drop_slice', "
                         f"not {on_error!r}")


def get_tokenizer(num_threads: int = 0, on_error: str = "raise"):
    """``on_error``: "raise" aborts the decode on the first malformed slice;
    "drop_slice" contains the damage to the failing slice (its parsed prefix
    is kept, the count is reported via ``PictureTokens.bad_slices``)."""
    _check_on_error(on_error)
    return native_tokenizer(num_threads, on_error)


def python_tokenizer(on_error: str = "raise"):
    """The pure-Python tokenizer, one slice after another (the JAX
    package's ``_python_tokenizer``); ``on_error`` as for
    :func:`get_tokenizer`."""
    _check_on_error(on_error)
    from .python_tok import tokenize_slice

    def tokenize(data, slices, params, geom) -> PictureTokens:
        tokens = PictureTokens.empty(geom)
        for bit_pos, code in slices:
            try:
                tokenize_slice(data, bit_pos, code, params, geom, tokens)
            except ValueError:
                if on_error != "drop_slice":
                    raise
                # containment: keep the slice's parsed prefix, count the drop
                tokens.bad_slices += 1
        return tokens

    return tokenize
