"""4+4-bit complex codec (port of ``caltech_bifrost_dsp_tpu/utils/codec.py``).

One byte per complex sample: the high nibble is the real part, the low
nibble the imaginary part, each a 4-bit two's-complement integer in
[-8, 7].  Sign extension uses the branch-free identity ``((v ^ 8) - 8)``
over ``v in [0, 15]``.  numpy versions serve the host side, torch versions
the device side.
"""

from __future__ import annotations

import numpy as np
import torch


def unpack_np(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint8 packed -> (real, imag) int8 arrays of the same shape."""
    p = np.asarray(packed, dtype=np.uint8)
    re = ((p >> 4).astype(np.int8) ^ 8) - 8
    im = ((p & 0xF).astype(np.int8) ^ 8) - 8
    return re, im


def unpack_complex_np(packed: np.ndarray) -> np.ndarray:
    """uint8 packed -> complex64 array (convenience for reference checks)."""
    re, im = unpack_np(packed)
    return re.astype(np.float32) + 1j * im.astype(np.float32)


def pack_np(re: np.ndarray, im: np.ndarray) -> np.ndarray:
    """(real, imag) ints in [-8, 7] -> uint8 packed."""
    re = np.asarray(re)
    im = np.asarray(im)
    if re.min(initial=0) < -8 or re.max(initial=0) > 7:
        raise ValueError("real part out of 4-bit range [-8, 7]")
    if im.min(initial=0) < -8 or im.max(initial=0) > 7:
        raise ValueError("imag part out of 4-bit range [-8, 7]")
    return (((re.astype(np.int64) & 0xF) << 4)
            | (im.astype(np.int64) & 0xF)).astype(np.uint8)


def unpack(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 packed tensor -> (real, imag) int8 tensors."""
    p = packed.to(torch.int16)
    re = ((p >> 4) ^ 8) - 8
    im = ((p & 0xF) ^ 8) - 8
    return re.to(torch.int8), im.to(torch.int8)


def pack(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """(real, imag) integer tensors in [-8, 7] -> uint8 packed."""
    r = re.to(torch.int16) & 0xF
    i = im.to(torch.int16) & 0xF
    return ((r << 4) | i).to(torch.uint8)
