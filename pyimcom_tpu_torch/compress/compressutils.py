"""
Block-file compression management and the transparent reader.

The port's copy of ``pyimcom_tpu/compress/compressutils.py``, so that the port imports
nothing of the JAX package; keep the two in step.

Counterpart of reference src/pyimcom/compress/compressutils.py: each
non-science layer of a block's primary data cube can be compressed with a
scheme from i24.py; the compressed planes move to ``HSHX<layer hex>`` HDUs
with overflow tables in ``HSHV<layer hex>``, and the scheme parameters are
recorded in the ``CPRESS`` ASCII table as ``LLLL:KEY:VALUE`` rows.
:func:`ReadFile` reads either form transparently (local path, gzip, or
http/s3 via fsspec), returning an HDUList with layers restored.
"""

from __future__ import annotations

import re
from urllib.parse import urlparse

import numpy as np

from ..fitsio import HDUList, ImageHDU, TableHDU, fits_read, fits_write
from .i24 import i24compress, i24decompress


def _overflow_to_hdu(overflow, name):
    t = TableHDU(data={
        "y": np.asarray(overflow["y"], dtype=np.int32),
        "x": np.asarray(overflow["x"], dtype=np.int32),
        "value": np.asarray(overflow["value"], dtype=np.float32),
    }, name=name)
    return t


def _overflow_from_hdu(hdu):
    if hdu is None:
        return None
    return {"y": hdu["y"], "x": hdu["x"], "value": hdu["value"]}


class CompressedOutput:
    """
    Compress / decompress the layers of a coadded block file.

    Parameters
    ----------
    fname : str -- block FITS file (possibly already compressed, possibly .gz)
    layers : list of int or None -- layers to decompress (None = all).
    """

    def __init__(self, fname, format=None, layers=None, hdul=None):
        from ..config import Config

        self.origfile = str(fname)
        self.gzip = self.origfile.endswith(".gz")
        self.decompress_layers = layers
        pref = self.origfile[:-3] if self.gzip else self.origfile
        if hdul is None and format is None and not pref.endswith(".fits"):
            # reference error contract (compressutils.py:101-116)
            raise Exception("unrecognized file type")
        self.ftype = "fits"
        self.hdul = hdul if hdul is not None else fits_read(self.origfile)
        self.cprstype = self.hdul[0].header.get("CPRSTYPE", "")
        self.hdul[0].header["CPRSTYPE"] = self.cprstype
        self.cfg = None
        for h in self.hdul:
            if h.header.get("EXTNAME") == "CONFIG":
                import json

                self.cfg = Config(json.loads("\n".join(str(r) for r in h.data["text"])))
                break

    # ----- compression -----------------------------------------------------

    def _cpress_rows(self):
        try:
            return [str(r) for r in self.hdul["CPRESS"]["text"]]
        except KeyError:
            return None

    def _set_cpress_rows(self, rows):
        t = TableHDU(data={"text": np.array(rows, dtype=str)}, name="CPRESS",
                     ascii_table=True)
        t.columns = [("text", "A512")]
        for i, h in enumerate(self.hdul):
            if h.name == "CPRESS":
                self.hdul[i] = t
                return
        self.hdul.append(t)

    def get_compression_dict(self, ilayer):
        """Scheme parameters previously recorded for a layer (str values)."""
        rows = self._cpress_rows()
        if rows is None:
            return {}
        out = {}
        for r in rows:
            parts = r.strip().split(":")
            if len(parts) >= 3 and int(parts[0], 16) == ilayer:
                out[parts[1].strip()] = parts[2].strip()
        return out

    def compress_layer(self, layerid, scheme=None, pars=None):
        """
        Compress layer `layerid` of the primary cube.  scheme=None re-uses
        the previously recorded scheme (or does nothing if there was none).
        """
        pars = dict(pars or {})
        if layerid == 0 or layerid >= 16 ** 4:
            return
        rows = self._cpress_rows()
        if rows is None:
            rows = []

        if scheme is None:
            cd = self.get_compression_dict(layerid)
            if "SCHEME" in cd:
                data, overflow = i24compress(self.hdul[0].data[0, layerid],
                                             cd["SCHEME"], cd)
                self.hdul[0].data[0, layerid] = 0
                newhdu = ImageHDU(data, name=f"HSHX{layerid:04X}")
                for k, v in cd.items():
                    newhdu.header[k] = v
                self.hdul.append(newhdu)
                self.hdul.append(_overflow_to_hdu(overflow, f"HSHV{layerid:04X}"))
                return
            scheme = "NULL"

        data, overflow = i24compress(self.hdul[0].data[0, layerid], scheme, pars)
        self.hdul[0].data = np.array(self.hdul[0].data)
        self.hdul[0].data[0, layerid] = 0
        newhdu = ImageHDU(data, name=f"HSHX{layerid:04X}")
        for k, v in pars.items():
            newhdu.header[k] = v
            rows.append(f"{layerid:04X}:{k:8s}:{v}")
        newhdu.header["SCHEME"] = scheme
        rows.append(f"{layerid:04X}:{'SCHEME':8s}:{scheme}")
        self.hdul.append(newhdu)
        if overflow is not None:
            self.hdul.append(_overflow_to_hdu(overflow, f"HSHV{layerid:04X}"))
        self._set_cpress_rows(rows)

    def decompress(self):
        """Restore all compressed layers into the primary cube."""
        self.hdul[0].data = np.array(self.hdul[0].data)
        j = 0
        while j < len(self.hdul):
            h = self.hdul[j]
            if h.name[:4] == "HSHX":
                layer = int(h.name[-4:], 16)
                if (self.decompress_layers is not None
                        and layer not in self.decompress_layers):
                    j += 1
                    continue
                try:
                    ovf = _overflow_from_hdu(self.hdul["HSHV" + h.name[-4:]])
                except KeyError:
                    ovf = None
                self.hdul[0].data[0, layer] = i24decompress(
                    h.data, str(h.header.get("SCHEME", "")), h.header, overflow=ovf)
                del self.hdul[j]
            else:
                j += 1
        j = 0
        while j < len(self.hdul):
            if self.hdul[j].name[:4] == "HSHV":
                del self.hdul[j]
            else:
                j += 1

    def recompress(self):
        """Re-compress every layer that was compressed before decompress()."""
        rows = self._cpress_rows()
        if rows is None:
            return
        nlayer = self.hdul[0].data.shape[-3]
        was = np.zeros(nlayer, dtype=bool)
        for r in rows:
            was[int(r.split(":")[0], 16)] = True
        for ilayer in range(nlayer):
            if was[ilayer]:
                self.compress_layer(ilayer)

    def to_file(self, fname, overwrite=False):
        fits_write(fname, self.hdul)

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()
        return False


def _parser(fname):
    """
    Expand '^'-templated file names: 'Row{1:d}/Q_{0:02d}_{1:02d}^_02_31.fits'
    -> 'Row31/Q_02_31.fits' (reference compressutils.py:394-441).
    """
    fname = str(fname)
    if "^" not in fname:
        return fname
    parts = fname.split("^")
    sub = parts[1].split(".")
    m = re.match(r"_(\d+)_(\d+)(\D*)", sub[0])
    ix = iy = 0
    term = ""
    if m is not None:
        ix, iy, term = int(m.group(1)), int(m.group(2)), m.group(3)
    suffix = term + "." + ".".join(sub[1:])
    return "^".join(parts[:-1]).format(ix, iy) + suffix


def ReadFile(fname, layers=None):
    """
    Read a (possibly compressed, gzipped, templated, or remote) block file,
    returning an HDUList with all layers restored.
    """
    fname = _parser(fname)
    o = urlparse(str(fname))
    if o.scheme in ("http", "https", "s3"):
        import fsspec

        kwargs = {"anon": True} if o.scheme == "s3" else {}
        with fsspec.open(o.geturl(), "rb", **kwargs) as f:
            data = f.read()
        hdus = fits_read(data)
    elif o.scheme and not (len(o.scheme) == 1 and o.scheme.isalpha()):
        # anything but a bare path or a Windows drive letter (reference
        # compressutils.py ReadFile scheme contract)
        raise ValueError(f"Scheme {o.scheme} not supported")
    else:
        hdus = fits_read(str(fname))

    if not any(h.name == "CPRESS" for h in hdus):
        return hdus

    x = CompressedOutput(str(fname), layers=layers, hdul=hdus)
    x.decompress()
    return HDUList(x.hdul)
