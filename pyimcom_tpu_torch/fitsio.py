"""
Minimal self-contained FITS reader/writer.

The port's copy of ``pyimcom_tpu/fitsio.py``, so that the port imports
nothing of the JAX package; keep the two in step.

The runtime environment for this framework does not ship astropy or cfitsio,
so the framework provides its own FITS layer.  It supports the subset of the
standard used by the coaddition pipeline (cf. reference usage in
src/pyimcom/coadd.py:2140-2328 and tests):

* primary and extension image HDUs (BITPIX 8/16/32/64/-32/-64, BSCALE/BZERO)
* binary tables (TFORM codes L, B, I, J, K, E, D, and rA strings)
* ASCII tables (TFORM A<w>, I<w>, F/E/D widths) -- used for the CONFIG HDU
* header keywords: bool / int / float / string, COMMENT/HISTORY

All I/O is numpy-based and vectorized; no external dependencies.
"""

from __future__ import annotations

import numpy as np

BLOCK = 2880
CARDLEN = 80

_BITPIX2DTYPE = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}
_DTYPE2BITPIX = {
    "uint8": 8, "int16": 16, "int32": 32, "int64": 64, "float32": -32, "float64": -64,
    # unsigned ints are stored with BZERO offsets
    "uint16": 16, "uint32": 32,
}

# binary table TFORM letter -> (numpy big-endian dtype, bytes)
_TFORM2DTYPE = {
    "L": (np.dtype("u1"), 1),
    "B": (np.dtype("u1"), 1),
    "I": (np.dtype(">i2"), 2),
    "J": (np.dtype(">i4"), 4),
    "K": (np.dtype(">i8"), 8),
    "E": (np.dtype(">f4"), 4),
    "D": (np.dtype(">f8"), 8),
}


class Header(dict):
    """FITS header: an ordered dict of keyword -> value, with comments."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.comments = {}

    def set(self, key, value, comment=None):
        self[key] = value
        if comment is not None:
            self.comments[key] = comment


def _format_card(key, value, comment=None):
    key = key.upper()[:8]
    if key in ("COMMENT", "HISTORY", ""):
        return f"{key:<8}{str(value):<72}"[:80]
    if isinstance(value, bool):
        vstr = f"{'T' if value else 'F':>20}"
    elif isinstance(value, (int, np.integer)):
        vstr = f"{int(value):>20d}"
    elif isinstance(value, (float, np.floating)):
        vstr = f"{float(value):>20.14G}"
        if "." not in vstr and "E" not in vstr and "NAN" not in vstr and "INF" not in vstr:
            vstr = f"{float(value):>20.1f}"
    else:
        s = str(value).replace("'", "''")
        vstr = f"'{s:<8}'"
    card = f"{key:<8}= {vstr}"
    if comment:
        card += f" / {comment}"
    return f"{card:<80}"[:80]


def _parse_card(card: str):
    key = card[:8].strip()
    if key in ("COMMENT", "HISTORY", "END", ""):
        return key, card[8:].strip(), None
    if card[8:10] != "= ":
        return key, card[8:].strip(), None
    rest = card[10:]
    comment = None
    if rest.lstrip().startswith("'"):
        # string value: find closing quote (doubled quotes are escaped)
        s = rest.lstrip()
        out, i = [], 1
        while i < len(s):
            if s[i] == "'":
                if i + 1 < len(s) and s[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(s[i])
            i += 1
        value = "".join(out).rstrip()
        tail = s[i + 1:]
        if "/" in tail:
            comment = tail.split("/", 1)[1].strip()
        return key, value, comment
    if "/" in rest:
        vpart, comment = rest.split("/", 1)
        comment = comment.strip()
    else:
        vpart = rest
    v = vpart.strip()
    if v == "T":
        return key, True, comment
    if v == "F":
        return key, False, comment
    try:
        return key, int(v), comment
    except ValueError:
        pass
    try:
        return key, float(v.replace("D", "E").replace("d", "e")), comment
    except ValueError:
        return key, v, comment


class HDU:
    """A single FITS header-data unit."""

    def __init__(self, data=None, header=None, name=None, is_table=False, ascii_table=False,
                 columns=None):
        self.data = data
        self.header = header if header is not None else Header()
        if name is not None:
            self.header["EXTNAME"] = name
        self.is_table = is_table
        self.ascii_table = ascii_table
        self.columns = columns  # list of (name, tform) for tables

    @property
    def name(self):
        return self.header.get("EXTNAME", "")


class ImageHDU(HDU):
    def __init__(self, data=None, header=None, name=None):
        super().__init__(data=data, header=header, name=name)


class TableHDU(HDU):
    """Table HDU; `data` is a dict of column name -> numpy array."""

    def __init__(self, data=None, header=None, name=None, ascii_table=False):
        super().__init__(data=data, header=header, name=name, is_table=True, ascii_table=ascii_table)

    def __getitem__(self, col):
        return self.data[col]

    @property
    def names(self):
        return list(self.data.keys())

    @property
    def nrows(self):
        if not self.data:
            return 0
        return len(next(iter(self.data.values())))


class HDUList(list):
    """List of HDUs with name-based lookup."""

    def __getitem__(self, key):
        if isinstance(key, str):
            for h in self:
                if h.name == key:
                    return h
            raise KeyError(key)
        return super().__getitem__(key)

    def writeto(self, fname, overwrite=True):
        fits_write(fname, self)

    # astropy-parity context-manager protocol (astropy HDULists are used
    # as `with fits.open(...) as f:`; buffers here are already in memory,
    # so close is a no-op)
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        return False

    def close(self):
        pass


# --------------------------------------------------------------------------
# reading
# --------------------------------------------------------------------------

def _read_header(buf, off):
    """Read header cards starting at `off`; return (Header, new offset)."""
    hdr = Header()
    while True:
        block = buf[off:off + BLOCK]
        if len(block) < BLOCK:
            raise ValueError("truncated FITS header")
        off += BLOCK
        text = block.decode("latin-1")
        done = False
        for i in range(0, BLOCK, CARDLEN):
            card = text[i:i + CARDLEN]
            key, value, comment = _parse_card(card)
            if key == "END":
                done = True
                break
            if key in ("COMMENT", "HISTORY"):
                hdr.setdefault(key, [])
                hdr[key].append(value)
                continue
            if key:
                hdr[key] = value
                if comment:
                    hdr.comments[key] = comment
        if done:
            break
    return hdr, off


def _pad_to_block(n):
    return ((n + BLOCK - 1) // BLOCK) * BLOCK


def _read_image_data(hdr, buf, off):
    bitpix = hdr["BITPIX"]
    naxis = hdr["NAXIS"]
    shape = tuple(int(hdr[f"NAXIS{i}"]) for i in range(naxis, 0, -1))
    count = int(np.prod(shape)) if shape else 0
    dt = _BITPIX2DTYPE[bitpix]
    nbytes = count * dt.itemsize
    if count:
        data = np.frombuffer(buf[off:off + nbytes], dtype=dt, count=count).reshape(shape)
        data = data.astype(dt.newbyteorder("="))
        bscale = hdr.get("BSCALE", 1)
        bzero = hdr.get("BZERO", 0)
        if bscale != 1 or bzero != 0:
            if bscale == 1 and bitpix == 16 and bzero == 32768:
                data = (data.astype(np.int32) + 32768).astype(np.uint16)
            elif bscale == 1 and bitpix == 32 and bzero == 2147483648:
                data = (data.astype(np.int64) + 2147483648).astype(np.uint32)
            else:
                data = data * bscale + bzero
    else:
        data = None
    return data, off + _pad_to_block(nbytes)


def _parse_tform_bin(tform):
    tform = tform.strip()
    i = 0
    while i < len(tform) and tform[i].isdigit():
        i += 1
    repeat = int(tform[:i]) if i > 0 else 1
    code = tform[i]
    return repeat, code


def _read_bintable(hdr, buf, off):
    nrow = int(hdr["NAXIS2"])
    rowbytes = int(hdr["NAXIS1"])
    tfields = int(hdr["TFIELDS"])
    raw = np.frombuffer(buf[off:off + nrow * rowbytes], dtype="u1").reshape(nrow, rowbytes)
    cols = {}
    colinfo = []
    pos = 0
    for i in range(1, tfields + 1):
        name = str(hdr.get(f"TTYPE{i}", f"col{i}")).strip()
        tform = str(hdr[f"TFORM{i}"]).strip()
        repeat, code = _parse_tform_bin(tform)
        colinfo.append((name, tform))
        if code == "A":
            width = repeat
            sub = raw[:, pos:pos + width]
            cols[name] = np.array([bytes(r).decode("latin-1").rstrip() for r in sub])
            pos += width
        else:
            dt, size = _TFORM2DTYPE[code]
            nbytes = repeat * size
            sub = raw[:, pos:pos + nbytes].copy()
            arr = sub.view(dt).reshape(nrow, repeat)
            arr = arr.astype(dt.newbyteorder("="))
            if code == "L":
                arr = arr == ord("T")
            if repeat == 1:
                arr = arr[:, 0]
            cols[name] = arr
            pos += nbytes
    return cols, colinfo, off + _pad_to_block(nrow * rowbytes)


def _read_asciitable(hdr, buf, off):
    nrow = int(hdr["NAXIS2"])
    rowbytes = int(hdr["NAXIS1"])
    tfields = int(hdr["TFIELDS"])
    raw = buf[off:off + nrow * rowbytes]
    cols = {}
    colinfo = []
    for i in range(1, tfields + 1):
        name = str(hdr.get(f"TTYPE{i}", f"col{i}")).strip()
        tform = str(hdr[f"TFORM{i}"]).strip()
        tbcol = int(hdr[f"TBCOL{i}"]) - 1
        colinfo.append((name, tform))
        code = tform[0]
        width = int(tform[1:].split(".")[0])
        vals = []
        for r in range(nrow):
            field = raw[r * rowbytes + tbcol: r * rowbytes + tbcol + width].decode("latin-1")
            vals.append(field)
        if code == "A":
            cols[name] = np.array([v.rstrip() for v in vals])
        elif code == "I":
            cols[name] = np.array([int(v) for v in vals])
        else:
            cols[name] = np.array([float(v.replace("D", "E")) for v in vals])
    return cols, colinfo, off + _pad_to_block(nrow * rowbytes)


def fits_read(fname) -> HDUList:
    """
    Read a FITS file and return an HDUList.

    `fname` may be a path (gzipped files are detected by magic), a bytes
    object, or a binary file-like object.
    """
    if isinstance(fname, (bytes, bytearray)):
        buf = bytes(fname)
    elif hasattr(fname, "read"):
        buf = fname.read()
    else:
        with open(fname, "rb") as f:
            buf = f.read()
    if buf[:2] == b"\x1f\x8b":
        import gzip

        buf = gzip.decompress(buf)
    if len(buf) < BLOCK or not buf.startswith(b"SIMPLE "):
        raise ValueError(f"{fname}: not a FITS file")
    hdus = HDUList()
    off = 0
    first = True
    while off < len(buf):
        if len(buf) - off < BLOCK:
            break
        hdr, off = _read_header(buf, off)
        xt = str(hdr.get("XTENSION", "")).strip() if not first else "IMAGE"
        first = False
        if xt in ("", "IMAGE"):
            data, off = _read_image_data(hdr, buf, off)
            hdus.append(ImageHDU(data=data, header=hdr))
        elif xt == "BINTABLE":
            cols, colinfo, off = _read_bintable(hdr, buf, off)
            t = TableHDU(data=cols, header=hdr)
            t.columns = colinfo
            hdus.append(t)
        elif xt == "TABLE":
            cols, colinfo, off = _read_asciitable(hdr, buf, off)
            t = TableHDU(data=cols, header=hdr, ascii_table=True)
            t.columns = colinfo
            hdus.append(t)
        else:
            raise ValueError(f"unsupported XTENSION {xt!r}")
    return hdus


# --------------------------------------------------------------------------
# writing
# --------------------------------------------------------------------------

def _write_header_cards(cards):
    text = "".join(cards)
    text += f"{'END':<80}"
    npad = _pad_to_block(len(text)) - len(text)
    text += " " * npad
    return text.encode("latin-1")


def _image_bytes(data, header, primary):
    cards = []
    if data is None:
        bitpix, shape = 8, ()
    else:
        data = np.asarray(data)
        key = str(data.dtype)
        if key == "bool":
            data = data.astype(np.uint8)
            key = "uint8"
        if key not in _DTYPE2BITPIX:
            data = data.astype(np.float64)
            key = "float64"
        bitpix = _DTYPE2BITPIX[key]
        shape = data.shape
    if primary:
        cards.append(_format_card("SIMPLE", True, "conforms to FITS standard"))
    else:
        cards.append(_format_card("XTENSION", "IMAGE", "Image extension"))
    cards.append(_format_card("BITPIX", bitpix))
    cards.append(_format_card("NAXIS", len(shape)))
    for i, n in enumerate(reversed(shape)):
        cards.append(_format_card(f"NAXIS{i + 1}", int(n)))
    if not primary:
        cards.append(_format_card("PCOUNT", 0))
        cards.append(_format_card("GCOUNT", 1))
    bzero = 0
    if data is not None:
        if data.dtype == np.uint16:
            bzero = 32768
            data = (data.astype(np.int32) - 32768).astype(np.int16)
        elif data.dtype == np.uint32:
            bzero = 2147483648
            data = (data.astype(np.int64) - 2147483648).astype(np.int32)
        if bzero:
            cards.append(_format_card("BSCALE", 1))
            cards.append(_format_card("BZERO", bzero))
    if header:
        for k, v in header.items():
            if k in ("SIMPLE", "XTENSION", "BITPIX", "NAXIS", "PCOUNT", "GCOUNT", "BSCALE", "BZERO") \
                    or k.startswith("NAXIS"):
                continue
            if k in ("COMMENT", "HISTORY"):
                for line in (v if isinstance(v, list) else [v]):
                    cards.append(_format_card(k, line))
                continue
            cards.append(_format_card(k, v, header.comments.get(k) if isinstance(header, Header) else None))
    out = _write_header_cards(cards)
    if data is not None and data.size:
        dt = _BITPIX2DTYPE[bitpix]
        raw = data.astype(dt).tobytes()
        pad = _pad_to_block(len(raw)) - len(raw)
        out += raw + b"\0" * pad
    return out


def _guess_tform(arr):
    arr = np.asarray(arr)
    if arr.dtype == bool:
        return "L"
    if arr.dtype.kind == "U" or arr.dtype.kind == "S":
        width = int(arr.dtype.itemsize // (4 if arr.dtype.kind == "U" else 1))
        return f"{max(width, 1)}A"
    k = arr.dtype.kind
    rep = 1 if arr.ndim == 1 else int(np.prod(arr.shape[1:]))
    pre = "" if rep == 1 else str(rep)
    if k in "iu":
        size = arr.dtype.itemsize
        return pre + {1: "B", 2: "I", 4: "J", 8: "K"}[size]
    if k == "f":
        return pre + ("E" if arr.dtype.itemsize == 4 else "D")
    raise ValueError(f"unsupported column dtype {arr.dtype}")


def _bintable_bytes(hdu):
    cols = hdu.data
    names = list(cols.keys())
    tforms = []
    arrays = []
    for n in names:
        arr = np.asarray(cols[n])
        tf = None
        if hdu.columns:
            for cn, ctf in hdu.columns:
                if cn == n:
                    tf = ctf
        if tf is None:
            tf = _guess_tform(arr)
        tforms.append(tf)
        arrays.append(arr)
    nrow = len(arrays[0]) if arrays else 0

    # encode columns to fixed-width big-endian bytes
    encoded = []
    for arr, tf in zip(arrays, tforms):
        repeat, code = _parse_tform_bin(tf)
        if code == "A":
            width = repeat
            e = np.zeros((nrow, width), dtype="u1")
            e[:] = ord(" ")
            for r in range(nrow):
                s = str(arr[r])[:width].encode("latin-1")
                e[r, :len(s)] = np.frombuffer(s, dtype="u1")
            encoded.append(e)
        elif code == "L":
            e = np.where(np.asarray(arr, dtype=bool).reshape(nrow, -1), ord("T"), ord("F")).astype("u1")
            encoded.append(e)
        else:
            dt, size = _TFORM2DTYPE[code]
            if nrow == 0:
                encoded.append(np.zeros((0, repeat * size), dtype="u1"))
            else:
                e = np.asarray(arr).reshape(nrow, -1).astype(dt).view("u1").reshape(nrow, -1)
                encoded.append(e)
    rowbytes = sum(e.shape[1] for e in encoded) if encoded else 0
    raw = np.concatenate(encoded, axis=1) if encoded else np.zeros((0, 0), dtype="u1")

    cards = [
        _format_card("XTENSION", "BINTABLE", "binary table extension"),
        _format_card("BITPIX", 8),
        _format_card("NAXIS", 2),
        _format_card("NAXIS1", rowbytes),
        _format_card("NAXIS2", nrow),
        _format_card("PCOUNT", 0),
        _format_card("GCOUNT", 1),
        _format_card("TFIELDS", len(names)),
    ]
    for i, (n, tf) in enumerate(zip(names, tforms), start=1):
        cards.append(_format_card(f"TTYPE{i}", n))
        cards.append(_format_card(f"TFORM{i}", tf))
    for k, v in hdu.header.items():
        if k in ("XTENSION", "BITPIX", "NAXIS", "NAXIS1", "NAXIS2", "PCOUNT", "GCOUNT", "TFIELDS") \
                or k.startswith(("TTYPE", "TFORM", "TBCOL")):
            continue
        if k in ("COMMENT", "HISTORY"):
            for line in (v if isinstance(v, list) else [v]):
                cards.append(_format_card(k, line))
            continue
        cards.append(_format_card(k, v, hdu.header.comments.get(k)))
    out = _write_header_cards(cards)
    body = raw.tobytes()
    pad = _pad_to_block(len(body)) - len(body)
    return out + body + b"\0" * pad


def _asciitable_bytes(hdu):
    cols = hdu.data
    names = list(cols.keys())
    fields = []
    tforms = []
    for n in names:
        arr = np.asarray(cols[n])
        if arr.dtype.kind in "US":
            width = max((len(str(v)) for v in arr), default=1)
            tf = None
            if hdu.columns:
                for cn, ctf in hdu.columns:
                    if cn == n and ctf.startswith("A"):
                        tf = ctf
                        width = int(ctf[1:])
            if tf is None:
                tf = f"A{width}"
            vals = [f"{str(v):<{width}}"[:width] for v in arr]
        elif arr.dtype.kind in "iu":
            width = 20
            tf = f"I{width}"
            vals = [f"{int(v):>{width}d}" for v in arr]
        else:
            width = 24
            tf = f"D{width}.16"
            vals = [f"{float(v):>{width}.16E}" for v in arr]
        tforms.append(tf)
        fields.append(vals)
    nrow = len(fields[0]) if fields else 0
    widths = [len(f[0]) if f else 0 for f in fields]
    rowbytes = sum(widths) + max(len(widths) - 1, 0)  # single space between fields

    rows = []
    for r in range(nrow):
        rows.append(" ".join(f[r] for f in fields))
    raw = "".join(rows).encode("latin-1")

    cards = [
        _format_card("XTENSION", "TABLE", "ASCII table extension"),
        _format_card("BITPIX", 8),
        _format_card("NAXIS", 2),
        _format_card("NAXIS1", rowbytes),
        _format_card("NAXIS2", nrow),
        _format_card("PCOUNT", 0),
        _format_card("GCOUNT", 1),
        _format_card("TFIELDS", len(names)),
    ]
    tbcol = 1
    for i, (n, tf, w) in enumerate(zip(names, tforms, widths), start=1):
        cards.append(_format_card(f"TTYPE{i}", n))
        cards.append(_format_card(f"TFORM{i}", tf))
        cards.append(_format_card(f"TBCOL{i}", tbcol))
        tbcol += w + 1
    for k, v in hdu.header.items():
        if k in ("XTENSION", "BITPIX", "NAXIS", "NAXIS1", "NAXIS2", "PCOUNT", "GCOUNT", "TFIELDS") \
                or k.startswith(("TTYPE", "TFORM", "TBCOL")):
            continue
        if k in ("COMMENT", "HISTORY"):
            for line in (v if isinstance(v, list) else [v]):
                cards.append(_format_card(k, line))
            continue
        cards.append(_format_card(k, v, hdu.header.comments.get(k)))
    out = _write_header_cards(cards)
    pad = _pad_to_block(len(raw)) - len(raw)
    return out + raw + b" " * pad


def fits_write(fname, hdus) -> None:
    """Write a list of HDUs to a FITS file (gzipped when fname ends in .gz)."""
    chunks = []
    for i, hdu in enumerate(hdus):
        if hdu.is_table:
            if i == 0:
                chunks.append(_image_bytes(None, Header(), primary=True))
            if hdu.ascii_table:
                chunks.append(_asciitable_bytes(hdu))
            else:
                chunks.append(_bintable_bytes(hdu))
        else:
            chunks.append(_image_bytes(hdu.data, hdu.header, primary=(i == 0)))
    payload = b"".join(chunks)
    if str(fname).endswith(".gz"):
        import gzip

        payload = gzip.compress(payload)
    with open(fname, "wb") as f:
        f.write(payload)
