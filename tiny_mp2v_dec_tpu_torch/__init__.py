"""tiny_mp2v_dec_tpu_torch — the PyTorch + CUDA port of the JAX decoder in ``tiny_mp2v_dec_tpu/``.

The same MPEG-2 (ISO/IEC 13818-2) decoder for an NVIDIA GPU: the native C++
tokenizer turns each picture into dense tensors on the host; the IDCT,
motion compensation and reconstruction run on the device as hand-written
CUDA kernels (``csrc/``), each beside a plain PyTorch version that tensors
on the CPU take.  The package imports torch and numpy, never JAX and never
the JAX package, which stays the reference the port is held against.
"""
from .runtime.decoder import DecoderConfig, MP2VDecoder
from .tokenizer.types import PictureGeometry

__all__ = ["MP2VDecoder", "DecoderConfig", "PictureGeometry"]
