"""
Self-contained ASDF reader/writer and a GWCS-subset evaluator.

The port's copy of ``pyimcom_tpu/asdfio.py``, so that the port imports
nothing of the JAX package; keep the two in step.

The reference pipeline opens Roman L2 products with the `asdf` package and
wraps the embedded GWCS (coadd.py:110-113, layer.py:1036-1045 in
Roman-HLIS-Cosmology-PIT/pyimcom); neither `asdf` nor `gwcs` is available
here, so this module implements the pieces the pipeline actually needs:

* the ASDF 1.0 container: '#ASDF' header, YAML tree (parsed with PyYAML,
  unknown tags preserved as :class:`Tagged`), and the binary block section
  (magic 0xd3 'BLK', big-endian header, raw or zlib payloads);
* `!core/ndarray` materialization (source blocks or inline data);
* an evaluator for the astropy.modeling subset that romanisim-style GWCS
  pipelines serialize (shift/scale/polynomial/affine/remap_axes/
  rotate_sequence_3d/gnomonic/compose/concatenate), exposed through the
  same pix2world/world2pix surface as :class:`pyimcom_tpu_torch.wcsutil.WCS`;
* a minimal writer (uncompressed blocks) so caches and tests can round-trip.

Scope: read-what-we-write plus the standard L2 layouts; exotic features
(strides, views, external blocks, block index validation) are rejected with
clear errors rather than silently misread.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np
import yaml

BLOCK_MAGIC = b"\xd3BLK"

_DTYPES = {
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "int64": "i8", "uint64": "u8",
    "float32": "f4", "float64": "f8", "complex64": "c8",
    "complex128": "c16", "bool8": "b1",
}
_DTYPES_INV = {np.dtype(v).name if k != "bool8" else "bool": k
               for k, v in _DTYPES.items()}


class Tagged:
    """A YAML node with an unrecognized (or structural) ASDF tag."""

    def __init__(self, tag: str, value):
        self.tag = tag
        self.value = value

    def __repr__(self):
        return f"Tagged({self.tag!r}, {self.value!r})"

    def __getitem__(self, key):
        return self.value[key]

    def get(self, key, default=None):
        if isinstance(self.value, dict):
            return self.value.get(key, default)
        return default


class NDArrayRef:
    """Lazy `!core/ndarray` node; resolved against the block list."""

    def __init__(self, node):
        self.node = node

    def resolve(self, blocks):
        nd = self.node
        if isinstance(nd, dict) and "source" in nd:
            src = nd["source"]
            if not isinstance(src, int) or src < 0:
                raise ValueError(f"unsupported ndarray source {src!r}")
            raw = blocks[src]
            dt = nd.get("datatype", "float64")
            if not isinstance(dt, str) or dt not in _DTYPES:
                raise ValueError(f"unsupported ndarray datatype {dt!r}")
            order = "<" if nd.get("byteorder", "little") == "little" else ">"
            dtype = np.dtype(order + _DTYPES[dt])
            shape = tuple(nd.get("shape", ()))
            offset = nd.get("offset", 0)
            if nd.get("strides") is not None:
                raise ValueError("strided ndarrays are not supported")
            count = int(np.prod(shape)) if shape else 1
            arr = np.frombuffer(raw, dtype=dtype, count=count, offset=offset)
            return arr.reshape(shape).copy()
        # inline data
        data = nd["data"] if isinstance(nd, dict) else nd
        return np.asarray(data)


def _make_loader():
    class _Loader(yaml.SafeLoader):
        pass

    def construct_tagged(loader, tag_suffix, node):
        if isinstance(node, yaml.MappingNode):
            value = loader.construct_mapping(node, deep=True)
        elif isinstance(node, yaml.SequenceNode):
            value = loader.construct_sequence(node, deep=True)
        else:
            value = loader.construct_scalar(node)
        if tag_suffix.startswith("core/ndarray"):
            return NDArrayRef(value)
        return Tagged(tag_suffix, value)

    _Loader.add_multi_constructor("tag:stsci.edu:asdf/", construct_tagged)
    _Loader.add_multi_constructor("tag:astropy.org:astropy/", construct_tagged)
    _Loader.add_multi_constructor("!", construct_tagged)
    return _Loader


def _read_blocks(buf: bytes, start: int) -> list:
    """Parse the binary block section starting at `start`."""
    blocks = []
    pos = start
    while True:
        idx = buf.find(BLOCK_MAGIC, pos)
        if idx < 0:
            break
        p = idx + 4
        (hdr_size,) = struct.unpack(">H", buf[p:p + 2])
        p += 2
        hdr = buf[p:p + hdr_size]
        comp = hdr[4:8].rstrip(b"\0").decode() or None
        allocated, used, _data_size = struct.unpack(">QQQ", hdr[8:32])
        data = buf[p + hdr_size:p + hdr_size + used]
        if comp == "zlib":
            data = zlib.decompress(data)
        elif comp is not None:
            raise ValueError(f"unsupported block compression {comp!r}")
        blocks.append(data)
        pos = p + hdr_size + allocated
    return blocks


def _materialize(node, blocks):
    if isinstance(node, NDArrayRef):
        return node.resolve(blocks)
    if isinstance(node, dict):
        return {k: _materialize(v, blocks) for k, v in node.items()}
    if isinstance(node, list):
        return [_materialize(v, blocks) for v in node]
    if isinstance(node, Tagged):
        node.value = _materialize(node.value, blocks)
        return node
    return node


def asdf_read(path_or_bytes):
    """
    Read an ASDF file into a Python tree: plain dicts/lists/scalars, numpy
    arrays for ndarray nodes, :class:`Tagged` wrappers for everything with
    an unrecognized tag (GWCS objects, units, times, ...).
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    if not buf.startswith(b"#ASDF"):
        raise ValueError("not an ASDF file")

    end = buf.find(b"\n...", buf.find(b"\n---"))
    if end < 0:
        raise ValueError("no YAML document end marker in ASDF file")
    yaml_text = buf[:end + 4].decode("utf-8", errors="replace")
    yaml_text = "\n".join(ln for ln in yaml_text.splitlines()
                          if not ln.startswith("#"))
    tree = yaml.load(yaml_text, Loader=_make_loader())
    blocks = _read_blocks(buf, end + 4)
    return _materialize(tree, blocks)


def asdf_write(path, tree) -> None:
    """
    Write a tree (dicts/lists/scalars/numpy arrays) as a minimal ASDF file
    (uncompressed blocks, little-endian).
    """
    blocks = []

    def encode(node):
        if isinstance(node, np.ndarray):
            arr = np.ascontiguousarray(node)
            if arr.dtype.byteorder == ">":
                arr = arr.astype(arr.dtype.newbyteorder("<"))
            name = _DTYPES_INV.get(arr.dtype.name)
            if name is None:
                raise ValueError(f"unsupported dtype {arr.dtype}")
            blocks.append(arr.tobytes())
            return Tagged("core/ndarray-1.0.0",
                          {"source": len(blocks) - 1, "datatype": name,
                           "byteorder": "little",
                           "shape": list(arr.shape)})
        if isinstance(node, Tagged):
            return Tagged(node.tag, encode(node.value))
        if isinstance(node, dict):
            return {k: encode(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [encode(v) for v in node]
        if isinstance(node, (np.integer,)):
            return int(node)
        if isinstance(node, (np.floating,)):
            return float(node)
        return node

    class _Dumper(yaml.SafeDumper):
        pass

    def represent_tagged(dumper, t):
        if isinstance(t.value, dict):
            return dumper.represent_mapping(
                "tag:stsci.edu:asdf/" + t.tag, t.value)
        if isinstance(t.value, list):
            return dumper.represent_sequence(
                "tag:stsci.edu:asdf/" + t.tag, t.value)
        return dumper.represent_scalar("tag:stsci.edu:asdf/" + t.tag,
                                       str(t.value))

    _Dumper.add_representer(Tagged, represent_tagged)

    doc = yaml.dump(encode(tree), Dumper=_Dumper,
                    default_flow_style=False, sort_keys=False)
    out = io.BytesIO()
    out.write(b"#ASDF 1.0.0\n#ASDF_STANDARD 1.5.0\n%YAML 1.1\n")
    out.write(b"%TAG ! tag:stsci.edu:asdf/\n--- !core/asdf-1.1.0\n")
    out.write(doc.encode())
    out.write(b"...\n")
    for data in blocks:
        hdr = struct.pack(">I", 0) + b"\0\0\0\0" \
            + struct.pack(">QQQ", len(data), len(data), len(data)) \
            + b"\0" * 16
        out.write(BLOCK_MAGIC + struct.pack(">H", len(hdr)) + hdr + data)
    with open(path, "wb") as f:
        f.write(out.getvalue())


# --------------------------------------------------------------------------
# GWCS transform-subset evaluator
# --------------------------------------------------------------------------

DEG = np.pi / 180.0


def _rot3d(angles_deg, axes_order):
    """Composite rotation matrix for a rotate_sequence_3d node.

    astropy/gwcs semantics (astropy.modeling.rotations.RotationSequence3D
    over astropy.coordinates rotation_matrix): each angle is a PASSIVE
    (frame) right-handed rotation about its axis, applied to the vector in
    the order listed.  Validated against the JWST/Roman ``v23tosky``
    composition -- angles [v2, -v3, roll, dec, -ra] over 'zyxyz' must map
    the reference point (v2, v3) to (ra, dec) with +v3 toward celestial
    north at roll 0; only this convention satisfies that
    (tests/test_asdfio.py::test_rotate_sequence_convention)."""
    R = np.eye(3)
    for ang, ax in zip(angles_deg, axes_order):
        c, s = np.cos(ang * DEG), np.sin(ang * DEG)
        if ax == "x":
            M = np.array([[1, 0, 0], [0, c, s], [0, -s, c]])
        elif ax == "y":
            M = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
        else:
            M = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
        R = M @ R
    return R


class _Model:
    """One evaluable transform node: maps a tuple of arrays to a tuple."""

    def __init__(self, tag: str, node: dict):
        self.kind = None
        t = tag.split("/")[-1].rsplit("-", 1)[0]  # e.g. 'shift'
        self.kind = t
        v = node
        if t == "compose":
            self.parts = [build_transform(p) for p in v["forward"]]
            self.n_in = self.parts[0].n_in
            self.n_out = self.parts[-1].n_out
        elif t == "concatenate":
            self.parts = [build_transform(p) for p in v["forward"]]
            self.n_in = sum(p.n_in for p in self.parts)
            self.n_out = sum(p.n_out for p in self.parts)
        elif t == "remap_axes":
            self.mapping = list(v["mapping"])
            self.n_in = (v.get("n_inputs") or max(self.mapping) + 1)
            self.n_out = len(self.mapping)
        elif t == "shift":
            self.offset = float(np.asarray(v["offset"]).ravel()[0])
            self.n_in = self.n_out = 1
        elif t == "scale":
            self.factor = float(np.asarray(v["factor"]).ravel()[0])
            self.n_in = self.n_out = 1
        elif t == "polynomial":
            self.coef = np.asarray(v["coefficients"], dtype=np.float64)
            self.n_in = self.coef.ndim
            self.n_out = 1
        elif t == "affine":
            self.matrix = np.asarray(v["matrix"], dtype=np.float64)
            self.translation = np.asarray(
                v.get("translation", np.zeros(2)), dtype=np.float64)
            self.n_in = self.n_out = 2
        elif t == "rotate_sequence_3d":
            self.R = _rot3d(np.asarray(v["angles"], dtype=np.float64),
                            str(v["axes_order"]))
            self.n_in = self.n_out = 2
        elif t in ("gnomonic", "stereographic", "arc",
                   "zenithal_equidistant"):
            self.kind = "arc" if t == "zenithal_equidistant" else t
            self.direction = v.get("direction", "pix2sky")
            self.n_in = self.n_out = 2
        elif t == "identity":
            self.n_in = self.n_out = int(v.get("n_dims", 2))
        else:
            raise ValueError(f"unsupported GWCS transform tag {tag!r}")

    def __call__(self, *args):
        t = self.kind
        if t == "compose":
            out = args
            for p in self.parts:
                out = p(*out)
            return out
        if t == "concatenate":
            out = []
            i = 0
            for p in self.parts:
                out.extend(p(*args[i:i + p.n_in]))
                i += p.n_in
            return tuple(out)
        if t == "remap_axes":
            return tuple(args[m] for m in self.mapping)
        if t == "shift":
            return (args[0] + self.offset,)
        if t == "scale":
            return (args[0] * self.factor,)
        if t == "polynomial":
            if self.n_in == 1:
                return (np.polynomial.polynomial.polyval(args[0], self.coef),)
            return (np.polynomial.polynomial.polyval2d(
                args[0], args[1], self.coef),)
        if t == "affine":
            x = self.matrix[0, 0] * args[0] + self.matrix[0, 1] * args[1] \
                + self.translation[0]
            y = self.matrix[1, 0] * args[0] + self.matrix[1, 1] * args[1] \
                + self.translation[1]
            return (x, y)
        if t == "rotate_sequence_3d":
            lon, lat = np.asarray(args[0]) * DEG, np.asarray(args[1]) * DEG
            vec = np.stack([np.cos(lat) * np.cos(lon),
                            np.cos(lat) * np.sin(lon), np.sin(lat)])
            out = np.tensordot(self.R, vec, axes=(1, 0))
            lon2 = np.arctan2(out[1], out[0]) / DEG % 360.0
            lat2 = np.arcsin(np.clip(out[2], -1, 1)) / DEG
            return (lon2, lat2)
        if t in ("gnomonic", "stereographic", "arc"):
            if self.direction == "pix2sky":
                x, y = np.asarray(args[0]) * DEG, np.asarray(args[1]) * DEG
                rho = np.hypot(x, y)
                if t == "gnomonic":
                    theta = np.arctan2(1.0, rho)       # native latitude
                elif t == "stereographic":
                    theta = np.pi / 2 - 2 * np.arctan(rho / 2.0)
                else:                                  # zenithal equidistant
                    theta = np.pi / 2 - rho
                phi = np.arctan2(x, -y)
                return (phi / DEG, theta / DEG)
            phi = np.asarray(args[0]) * DEG
            theta = np.asarray(args[1]) * DEG
            if t == "gnomonic":
                rho = 1.0 / np.maximum(np.tan(theta), 1e-300)
            elif t == "stereographic":
                rho = 2.0 * np.tan(np.pi / 4 - theta / 2.0)
            else:
                rho = np.pi / 2 - theta
            return (rho * np.sin(phi) / DEG, -rho * np.cos(phi) / DEG)
        if t == "identity":
            return args
        raise AssertionError(t)


def build_transform(node):
    """Build an evaluable transform from a Tagged GWCS model node."""
    if isinstance(node, _Model):
        return node
    if not isinstance(node, Tagged):
        raise ValueError(f"not a transform node: {node!r}")
    return _Model(node.tag, node.value)


class GWCS:
    """
    Evaluable wrapper around a serialized GWCS object (`!<gwcs/wcs>` node):
    the composed forward transform of all steps, with `pix2world` /
    `world2pix` matching :class:`pyimcom_tpu_torch.wcsutil.WCS` (0-indexed
    pixels, degrees).  The inverse runs Newton iterations on the forward
    model (cf. reference wcsutil.py:459-517 'ASTROPY+' approximation).
    """

    def __init__(self, node):
        v = node.value if isinstance(node, Tagged) else node
        steps = v["steps"]
        parts = []
        for s in steps:
            sv = s.value if isinstance(s, Tagged) else s
            tr = sv.get("transform")
            if tr is not None:
                parts.append(build_transform(tr))
        if not parts:
            raise ValueError("GWCS has no transforms")
        self._parts = parts

    def pix2world(self, x, y):
        out = (np.asarray(x, dtype=np.float64),
               np.asarray(y, dtype=np.float64))
        for p in self._parts:
            out = p(*out)
        return out[0], out[1]

    def world2pix(self, ra, dec, niter: int = 12):
        ra = np.asarray(ra, dtype=np.float64)
        dec = np.asarray(dec, dtype=np.float64)
        x = np.zeros_like(ra)
        y = np.zeros_like(ra)
        for _ in range(niter):
            r0, d0 = self.pix2world(x, y)
            cosd = np.cos(np.clip(d0, -89.999, 89.999) * DEG)
            dra = ((ra - r0 + 180.0) % 360.0 - 180.0) * cosd
            ddec = dec - d0
            eps = 0.5
            rx, dx_ = self.pix2world(x + eps, y)
            ry, dy_ = self.pix2world(x, y + eps)
            j00 = ((rx - r0 + 180.0) % 360.0 - 180.0) * cosd / eps
            j10 = (dx_ - d0) / eps
            j01 = ((ry - r0 + 180.0) % 360.0 - 180.0) * cosd / eps
            j11 = (dy_ - d0) / eps
            det = j00 * j11 - j01 * j10
            det = np.where(np.abs(det) < 1e-30, 1e-30, det)
            x = x + (j11 * dra - j01 * ddec) / det
            y = y + (-j10 * dra + j00 * ddec) / det
        return x, y
