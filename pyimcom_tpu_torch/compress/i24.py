"""
24-bit integer quantization codec ("I24") for float image layers.

The port's copy of ``pyimcom_tpu/compress/i24.py``, so that the port imports
nothing of the JAX package; keep the two in step.

Counterpart of reference src/pyimcom/compress/i24.py; bit-stream compatible.
The pipeline (each stage invertible; overflow values stored exactly in a
side table):

1. power-law rescale of [VMIN, VMAX] to [0, 2^BITKEEP) with exponent ALPHA
2. optional successive-pixel differencing mod 2^BITKEEP (DIFF)
3. either a soft bias (SOFTBIAS > 0) or the small-number remap
   (SOFTBIAS == -1) so near-zero differences pack tightly
4. byte-plane split to uint8, optionally with the least-significant-bit-
   first bit transpose (REORDER) that groups the noisy low bits together
   for downstream gzip.

Schemes: 'I24A' stops at int32; 'I24B' produces the uint8 plane cube.
"""

from __future__ import annotations

import numpy as np

RECOGNIZED_SCHEMES = ["I24A", "I24B"]


def lsbf_fwd(im: np.ndarray) -> np.ndarray:
    """Bit transpose of a uint8 image: output byte j collects input bit j
    across groups of 8 pixels (LSB first).  Applied per slice for 3D."""
    if im.ndim == 3:
        return np.stack([lsbf_fwd(sl) for sl in im])
    ny, nx = im.shape
    bits = np.unpackbits(im, bitorder="little").reshape(ny, nx, 8)
    return np.packbits(np.transpose(bits, (2, 0, 1)).reshape(ny, nx, 8),
                       bitorder="little").reshape(ny, nx)


def lsbf_rev(im: np.ndarray) -> np.ndarray:
    """Inverse of :func:`lsbf_fwd`."""
    if im.ndim == 3:
        return np.stack([lsbf_rev(sl) for sl in im])
    ny, nx = im.shape
    bits = np.unpackbits(im, bitorder="little").reshape(8, ny, nx)
    return np.packbits(np.transpose(bits, (1, 2, 0)),
                       bitorder="little").reshape(ny, nx)


def diff_fwd(im: np.ndarray, bitkeep: int) -> np.ndarray:
    """Successive differences mod 2^bitkeep (flattened row-major order)."""
    c = im.astype(np.int64).ravel().copy()
    c[1:] = c[1:] - c[:-1]
    c = (2 ** bitkeep + c) % 2 ** bitkeep
    return c.reshape(im.shape).astype(np.int32)


def diff_rev(im: np.ndarray, bitkeep: int) -> np.ndarray:
    """Inverse of :func:`diff_fwd` (cumulative sum mod 2^bitkeep)."""
    c = im.astype(np.uint32).ravel()
    c = np.cumsum(c, dtype=np.uint64) & np.uint64(2 ** bitkeep - 1)
    return c.reshape(im.shape).astype(np.int32)


def smallnum_fwd(im: np.ndarray, bitkeep: int) -> np.ndarray:
    """Zig-zag remap: small +/- values (mod 2^bitkeep) -> small unsigned."""
    return np.where(im >= 2 ** (bitkeep - 1), 2 * (2 ** bitkeep - im) - 1, 2 * im)


def smallnum_rev(im: np.ndarray, bitkeep: int) -> np.ndarray:
    """Inverse of :func:`smallnum_fwd`."""
    return np.where(im % 2, 2 ** bitkeep - 1 - im // 2, im // 2)


def _parse_pars(pars: dict):
    vmin = float(pars["VMIN"])
    vmax = float(pars["VMAX"])
    softbias = int(pars.get("SOFTBIAS", 0))
    diff = _as_bool(pars.get("DIFF", False))
    alpha = float(pars.get("ALPHA", 1.0))
    bitkeep = int(pars.get("BITKEEP", 24))
    if bitkeep >= 24 or bitkeep <= 0:
        if bitkeep != 24:
            raise ValueError(f"Can't keep {bitkeep} bits")
    reorder = _as_bool(pars.get("REORDER", True))
    return vmin, vmax, softbias, diff, alpha, bitkeep, reorder


def _as_bool(v):
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "t", "yes")
    return bool(v)


def quantize(im: np.ndarray, pars: dict):
    """float32 image -> (int32 image, overflow dict {y, x, value})."""
    vmin, vmax, softbias, diff, alpha, bitkeep, _ = _parse_pars(pars)
    posy, posx = np.where((im < vmin) | (im > vmax))
    overflow = {"y": posy.astype(np.int32), "x": posx.astype(np.int32),
                "value": im[posy, posx].astype(np.float32)}
    y = (np.clip(im, vmin, vmax) - vmin) / (vmax - vmin)
    y = 2 ** bitkeep * y ** alpha
    data = np.clip(np.floor(y).astype(np.int64), 0, 2 ** bitkeep - 1).astype(np.int32)
    if diff:
        data = diff_fwd(data, bitkeep)
    if softbias > 0:
        data = ((softbias + data.astype(np.int64)) % 2 ** bitkeep).astype(np.int32)
    elif softbias == -1:
        data = smallnum_fwd(data, bitkeep).astype(np.int32)
    return data, overflow


def dequantize(data: np.ndarray, pars: dict, overflow=None) -> np.ndarray:
    """int32 image -> float32 image (overflow values restored exactly)."""
    vmin, vmax, softbias, diff, alpha, bitkeep, _ = _parse_pars(pars)
    data = data.astype(np.int64)
    if softbias > 0:
        data = (2 ** bitkeep - softbias + data) % 2 ** bitkeep
    elif softbias == -1:
        data = smallnum_rev(data, bitkeep)
    if diff:
        data = diff_rev(data.astype(np.int32), bitkeep).astype(np.int64)
    y = (0.5 + data) / 2 ** bitkeep
    out = (vmin + (vmax - vmin) * y ** (1.0 / alpha)).astype(np.float32)
    if overflow is not None and len(overflow["y"]):
        out[np.asarray(overflow["y"], dtype=np.int64),
            np.asarray(overflow["x"], dtype=np.int64)] = overflow["value"]
    return out


def to_planes(data: np.ndarray, pars: dict) -> np.ndarray:
    """int32 image -> uint8 byte-plane cube ((bitkeep+7)//8, ny, nx)."""
    *_, bitkeep, reorder = _parse_pars(pars)
    nplane = (bitkeep + 7) // 8
    d = data.astype(np.int64).copy()
    planes = np.zeros((nplane,) + data.shape, dtype=np.uint8)
    for j in range(nplane):
        planes[j] = (d & 0xFF).astype(np.uint8)
        d >>= 8
    return lsbf_fwd(planes) if reorder else planes


def from_planes(planes: np.ndarray, pars: dict) -> np.ndarray:
    """uint8 byte-plane cube -> int32 image."""
    *_, reorder = _parse_pars(pars)
    x = (lsbf_rev(planes) if reorder else planes).astype(np.int32)
    out = np.zeros(planes.shape[-2:], dtype=np.int32)
    for j in range(x.shape[0]):
        out += x[j] << (8 * j)
    return out


def i24compress(im: np.ndarray, scheme: str, pars: dict):
    """Compress a float32 image; returns (data, overflow dict or None)."""
    if scheme not in RECOGNIZED_SCHEMES:
        return np.copy(im), None
    data, overflow = quantize(np.asarray(im, dtype=np.float32), pars)
    if scheme == "I24B":
        data = to_planes(data, pars)
    return data, overflow


def i24decompress(im: np.ndarray, scheme: str, pars: dict, overflow=None) -> np.ndarray:
    """Decompress an image produced by :func:`i24compress`."""
    if scheme not in RECOGNIZED_SCHEMES:
        return np.copy(im)
    data = np.asarray(im)
    if data.ndim == 3 and data.dtype == np.uint8:
        data = from_planes(data, pars)
    return dequantize(data.astype(np.int32), pars, overflow=overflow)
