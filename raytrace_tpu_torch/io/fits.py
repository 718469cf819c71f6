"""Minimal pure-numpy FITS writer (no cfitsio / astropy dependency).

A copy of ``raytrace_tpu/io/fits.py``, which is pure numpy: importing it
from the JAX package would import JAX and turn on its x64 mode. The two
write the same bytes (tests/test_torch_image.py).

Capability of the reference ``src/include/fits_output.h``: empty primary
HDU, 2-D image extensions (with the reference's transpose so FITS axis 1 is
the image x axis), multi-extension data cubes, binary tables, and typed
header keywords with comments and EXTNAME. Implements the FITS 4.0 standard
subset needed by the imaging apps; astropy (if present) reads the output
byte-for-byte.
"""

from __future__ import annotations

import numpy as np

_BLOCK = 2880
_CARD = 80

_DTYPE_BITPIX = {
    np.dtype(">u1"): 8,
    np.dtype(">i2"): 16,
    np.dtype(">i4"): 32,
    np.dtype(">i8"): 64,
    np.dtype(">f4"): -32,
    np.dtype(">f8"): -64,
}


def _card(key: str, value=None, comment: str | None = None) -> bytes:
    key = key.upper()[:8]
    if value is None:
        text = f"{key:<8}"
        if comment:
            text += f"  {comment}"
    else:
        if isinstance(value, bool):
            v = "T" if value else "F"
            val = f"{v:>20}"
        elif isinstance(value, (int, np.integer)):
            val = f"{value:>20d}"
        elif isinstance(value, (float, np.floating)):
            val = f"{value:>20.13E}"
        else:
            s = str(value).replace("'", "''")
            val = f"'{s:<8}'"
            val = f"{val:<20}"
        text = f"{key:<8}= {val}"
        if comment:
            text += f" / {comment}"
    return text[:_CARD].ljust(_CARD).encode("ascii")


def _pad_block(data: bytes, fill: bytes = b" ") -> bytes:
    rem = len(data) % _BLOCK
    if rem:
        data += fill * (_BLOCK - rem)
    return data


def _header(cards: list[bytes]) -> bytes:
    return _pad_block(b"".join(cards) + _card("END"))


def _to_big_endian(arr: np.ndarray) -> np.ndarray:
    dt = arr.dtype.newbyteorder(">")
    if dt not in _DTYPE_BITPIX:
        if arr.dtype.kind == "f":
            dt = np.dtype(">f8")
        elif arr.dtype.kind in "iub":
            dt = np.dtype(">i8") if arr.dtype.itemsize > 4 else np.dtype(">i4")
        else:
            raise TypeError(f"unsupported FITS dtype {arr.dtype}")
    return np.ascontiguousarray(arr, dtype=dt)


class FITSOutput:
    """Multi-extension FITS file writer (fits_output.h:46-362).

    Usage mirrors the reference: construct, write_image()/write_table() per
    extension, set_keyword() to annotate the most recent HDU, close().
    """

    def __init__(self, filename: str):
        self.filename = filename
        # primary HDU: no data (fits_output.h:111-128)
        self._hdus: list[dict] = [
            {
                "cards": [
                    _card("SIMPLE", True, "file conforms to FITS standard"),
                    _card("BITPIX", 8),
                    _card("NAXIS", 0),
                    _card("EXTEND", True),
                ],
                "data": b"",
            }
        ]

    def set_keyword(self, key: str, value, comment: str | None = None):
        self._hdus[-1]["cards"].append(_card(key, value, comment))

    def write_comment(self, comment: str):
        self._hdus[-1]["cards"].append(_card("COMMENT", None, comment))

    def write_image(self, data, extname: str | None = None, transpose: bool = True, flip_y: bool = False):
        """Append an IMAGE extension.

        ``transpose=True`` reproduces the reference's convention of writing
        image[x][y] arrays so that FITS axis 1 is x (fits_output.h:155-187);
        ``flip_y`` mirrors the y axis (used by the disc-image app when the
        observer orientation requires it).
        """
        arr = np.asarray(data)
        if flip_y and arr.ndim >= 2:
            arr = arr[:, ::-1] if transpose else arr[::-1, :]
        if transpose and arr.ndim == 2:
            arr = arr.T  # FITS is Fortran-ordered: axis1 varies fastest
        arr = _to_big_endian(arr)
        bitpix = _DTYPE_BITPIX[arr.dtype]
        # NAXISn are in Fortran order: NAXIS1 = last numpy axis
        shape_f = arr.shape[::-1]
        cards = [
            _card("XTENSION", "IMAGE", "IMAGE extension"),
            _card("BITPIX", bitpix),
            _card("NAXIS", arr.ndim),
        ]
        for i, n in enumerate(shape_f):
            cards.append(_card(f"NAXIS{i + 1}", int(n)))
        cards += [_card("PCOUNT", 0), _card("GCOUNT", 1)]
        if extname:
            cards.append(_card("EXTNAME", extname))
        self._hdus.append({"cards": cards, "data": arr.tobytes()})

    def write_table(self, columns: dict, extname: str | None = None):
        """Append a BINTABLE extension from {name: 1-D array} columns
        (fits_output.h:214-264)."""
        names = list(columns)
        arrays = [np.asarray(columns[n]) for n in names]
        nrows = len(arrays[0])
        fields = []
        for a in arrays:
            if a.dtype.kind == "f":
                fields.append((np.dtype(">f8"), "D"))
            elif a.dtype.kind in "iu":
                if a.dtype.itemsize > 4:
                    fields.append((np.dtype(">i8"), "K"))
                else:
                    fields.append((np.dtype(">i4"), "J"))
            else:
                raise TypeError(f"unsupported table column dtype {a.dtype}")
        rec = np.zeros(
            nrows, dtype=[(n, f[0]) for n, f in zip(names, fields)]
        )
        for n, a in zip(names, arrays):
            rec[n] = a
        cards = [
            _card("XTENSION", "BINTABLE", "binary table extension"),
            _card("BITPIX", 8),
            _card("NAXIS", 2),
            _card("NAXIS1", rec.dtype.itemsize),
            _card("NAXIS2", nrows),
            _card("PCOUNT", 0),
            _card("GCOUNT", 1),
            _card("TFIELDS", len(names)),
        ]
        for i, (n, f) in enumerate(zip(names, fields), start=1):
            cards.append(_card(f"TTYPE{i}", n))
            cards.append(_card(f"TFORM{i}", f[1]))
        if extname:
            cards.append(_card("EXTNAME", extname))
        self._hdus.append({"cards": cards, "data": rec.tobytes()})

    def close(self):
        with open(self.filename, "wb") as f:
            for hdu in self._hdus:
                f.write(_header(hdu["cards"]))
                if hdu["data"]:
                    f.write(_pad_block(hdu["data"], b"\x00"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_fits(filename: str) -> dict:
    """Minimal FITS reader for files written by FITSOutput (and compatible
    simple FITS): returns {extname_or_index: ndarray} plus "_headers" with
    the raw card dictionaries. Images only; data returned in the writer's
    (x, y) orientation (i.e. transposed back from FITS Fortran order)."""
    out = {}
    headers = {}
    raw = open(filename, "rb").read()
    pos = 0
    index = 0
    while pos < len(raw):
        cards = []
        while True:
            block = raw[pos:pos + _BLOCK]
            if len(block) < _BLOCK:
                return out | {"_headers": headers}
            pos += _BLOCK
            for i in range(0, _BLOCK, _CARD):
                cards.append(block[i:i + _CARD].decode("ascii", "replace"))
            if any(c.startswith("END") for c in cards):
                break
        hdr = {}
        for c in cards:
            if "=" in c[:10]:
                key = c[:8].strip()
                val = c[10:].split("/", 1)[0].strip()
                hdr[key] = val
        naxis = int(hdr.get("NAXIS", "0"))
        shape_f = [int(hdr[f"NAXIS{i + 1}"]) for i in range(naxis)]
        bitpix = int(hdr.get("BITPIX", "8"))
        dtype = {8: ">u1", 16: ">i2", 32: ">i4", 64: ">i8", -32: ">f4", -64: ">f8"}[bitpix]
        count = 1
        for s in shape_f:
            count *= s
        nbytes = count * abs(bitpix) // 8 if naxis else 0
        name = hdr.get("EXTNAME", "").strip("' ") or (f"HDU{index}" if index else "PRIMARY")
        is_table = "BINTABLE" in hdr.get("XTENSION", "")
        if naxis and not is_table:
            data = np.frombuffer(raw, dtype=dtype, count=count, offset=pos)
            # FITS is Fortran-ordered; undo the writer's transpose
            arr = data.reshape(shape_f[::-1])
            if arr.ndim == 2:
                arr = arr.T
            out[name] = arr
        headers[name] = hdr
        pos += -(-nbytes // _BLOCK) * _BLOCK
        index += 1
    out["_headers"] = headers
    return out
