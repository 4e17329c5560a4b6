"""Minimal NIfTI-1 reader/writer (pure numpy, no nibabel dependency).

The port's copy of ``neurovit_tpu/data/nifti.py``.
The reference reads fMRI volumes with nibabel/nilearn (``DatasetADNI.py:211``,
``DatasetPain.py:186``). This environment has neither, so the framework ships
its own NIfTI-1 codec with the two access patterns the pipeline needs:

- ``load(path)``: header + lazy data handle. For uncompressed files the data
  is **memory-mapped**, so slicing one timepoint out of a 4D series reads
  only that timepoint from disk (the reference's lazy ``dataobj[...]``
  pattern, and the fix for its PainDataset eager-read hot spot,
  SURVEY §2.1.12).
- ``save(path, array)``: write a float32 NIfTI-1 file (identity affine),
  used by visualization/Grad-CAM export.

Supports .nii and .nii.gz. Gzip has no random access, so a naive ``.nii.gz``
read decompresses the ENTIRE series per sample — exactly the reference's
PainDataset eager-read hot spot (``DatasetPain.py:186-188``) on the dominant
on-disk format. Instead, ``readable_path`` maintains a per-file decompressed
cache: the first touch of a ``.nii.gz`` inflates it once into a scratch
directory (atomic rename, mtime/size-keyed so stale entries are ignored);
every later access memmaps the cached ``.nii`` like an uncompressed file.
Disable with ``NEUROVIT_GZ_CACHE=0`` (falls back to
in-memory decompression per load). Only the fields the pipeline touches are
implemented: dims, dtype, vox_offset, scl_slope/inter.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import struct
import tempfile
import zlib
from typing import Optional, Tuple

import numpy as np

_HDR_SIZE = 348
_MAGIC_OFFSET = 344

# NIfTI datatype codes -> numpy dtypes (the subset seen in fMRI practice).
_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
    64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


class NiftiImage:
    """Lazy NIfTI-1 image: header fields + a ``dataobj`` that supports numpy
    basic indexing without loading the full array (for .nii via memmap)."""

    def __init__(self, shape: Tuple[int, ...], dataobj, scl_slope: float,
                 scl_inter: float, byteorder: str):
        self.shape = shape
        self.dataobj = dataobj
        self.scl_slope = scl_slope
        self.scl_inter = scl_inter
        self.byteorder = byteorder

    def get_fdata(self, dtype=np.float64) -> np.ndarray:
        data = np.asarray(self.dataobj).astype(dtype)
        if self.scl_slope not in (0.0, 1.0) or self.scl_inter != 0.0:
            slope = self.scl_slope if self.scl_slope != 0.0 else 1.0
            data = data * slope + self.scl_inter
        return data


def _parse_header(hdr: bytes):
    sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
    bo = "<"
    if sizeof_hdr != _HDR_SIZE:
        sizeof_hdr = struct.unpack(">i", hdr[0:4])[0]
        if sizeof_hdr != _HDR_SIZE:
            raise ValueError("Not a NIfTI-1 file (bad sizeof_hdr)")
        bo = ">"
    magic = hdr[_MAGIC_OFFSET:_MAGIC_OFFSET + 4]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError(f"Not a NIfTI-1 file (magic={magic!r})")
    dim = struct.unpack(bo + "8h", hdr[40:56])
    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1:1 + ndim])
    datatype = struct.unpack(bo + "h", hdr[70:72])[0]
    vox_offset = int(struct.unpack(bo + "f", hdr[108:112])[0])
    scl_slope = struct.unpack(bo + "f", hdr[112:116])[0]
    scl_inter = struct.unpack(bo + "f", hdr[116:120])[0]
    if datatype not in _DTYPES:
        raise ValueError(f"Unsupported NIfTI datatype code {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(bo)
    return shape, dtype, vox_offset, scl_slope, scl_inter, bo


def peek_shape(path: str) -> Tuple[int, ...]:
    """Header-only shape read (348 bytes)."""
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            hdr = f.read(_HDR_SIZE)
    else:
        with open(path, "rb") as f:
            hdr = f.read(_HDR_SIZE)
    return _parse_header(hdr)[0]


def default_gz_cache_dir() -> str:
    return os.environ.get(
        "NEUROVIT_GZ_CACHE_DIR",
        os.path.join(tempfile.gettempdir(), "neurovit_gz_cache"))


def readable_path(path: str,
                  cache_dir: Optional[str] = None) -> str:
    """Random-access-capable path for ``path``.

    ``.nii`` passes through. ``.nii.gz`` is inflated once into the cache
    directory (keyed on absolute path + mtime + size, so a replaced source
    file gets a fresh entry) and the cached ``.nii`` is returned — memmap
    slicing then works at full speed. Returns the
    original path when caching is disabled (NEUROVIT_GZ_CACHE=0) or the
    cache write fails (read-only scratch); callers fall back to in-memory
    decompression.
    """
    if not path.endswith(".gz"):
        return path
    if os.environ.get("NEUROVIT_GZ_CACHE", "1") == "0":
        return path
    tmp = None
    try:
        st = os.stat(path)
        abspath = os.path.abspath(path)
        # Two-part key: a path-only prefix (stable across file versions —
        # the eviction scope) and a version hash (mtime/size — a replaced
        # source file gets a fresh entry).
        phash = hashlib.sha1(abspath.encode()).hexdigest()[:12]
        vkey = hashlib.sha1(
            f"{st.st_mtime_ns}|{st.st_size}".encode()).hexdigest()[:12]
        base = os.path.basename(path)[:-3]           # strip ".gz"
        cache_dir = cache_dir or default_gz_cache_dir()
        entry = f"{phash}_{vkey}_{base}"
        dst = os.path.join(cache_dir, entry)
        if os.path.exists(dst):
            return dst
        os.makedirs(cache_dir, exist_ok=True)
        # Evict superseded entries for this SOURCE PATH only (same phash,
        # older version key) so the cache doesn't grow one full-size copy
        # per source-file version. Scoping eviction to the path hash — not
        # the basename — matters: neuroimaging corpora name every subject's
        # file identically (sub-NN/func.nii.gz), and basename-scoped
        # eviction would make subjects evict each other on every cold
        # lookup (permanent thrash + unlink races with concurrent readers).
        for name in os.listdir(cache_dir):
            if name.startswith(f"{phash}_") and name != entry:
                try:
                    os.remove(os.path.join(cache_dir, name))
                except OSError:
                    pass
        # Unique tmp per CALL (loader threads inflate the same series
        # concurrently on a cold cache; a shared pid-keyed tmp would let one
        # writer truncate another's file mid-write). os.replace publishes
        # atomically, so concurrent winners agree on the final bytes.
        fd, tmp = tempfile.mkstemp(prefix=f".{entry}.tmp",
                                   dir=cache_dir)
        with gzip.open(path, "rb") as src, os.fdopen(fd, "wb") as out:
            while True:
                chunk = src.read(1 << 24)
                if not chunk:
                    break
                out.write(chunk)
        os.replace(tmp, dst)
        tmp = None
        return dst
    except (OSError, EOFError, zlib.error):
        # OSError: unwritable scratch; EOFError/zlib.error: truncated or
        # corrupt .gz — fall back to the original path so the caller's
        # in-memory gunzip (or its own error handling) decides.
        return path
    finally:
        if tmp is not None:
            try:
                os.remove(tmp)
            except OSError:
                pass


def clear_gz_cache(cache_dir: Optional[str] = None) -> None:
    cache_dir = cache_dir or default_gz_cache_dir()
    if not os.path.isdir(cache_dir):
        return
    for name in os.listdir(cache_dir):
        try:
            os.remove(os.path.join(cache_dir, name))
        except OSError:
            pass


def load(path: str) -> NiftiImage:
    """Load a .nii / .nii.gz file lazily (memmap for uncompressed; gz routes
    through the decompressed cache so 4D series slice lazily too)."""
    if path.endswith(".gz"):
        path = readable_path(path)
    if path.endswith(".gz"):
        # Cache disabled/unavailable: whole-file in-memory decompression.
        with gzip.open(path, "rb") as f:
            raw = f.read()
        shape, dtype, off, slope, inter, bo = _parse_header(raw[:_HDR_SIZE])
        count = int(np.prod(shape))
        data = np.frombuffer(raw, dtype=dtype, count=count, offset=off)
        # NIfTI data is Fortran-ordered on disk.
        dataobj = data.reshape(shape, order="F")
    else:
        with open(path, "rb") as f:
            hdr = f.read(_HDR_SIZE)
        shape, dtype, off, slope, inter, bo = _parse_header(hdr)
        mm = np.memmap(path, dtype=dtype, mode="r", offset=off,
                       shape=shape, order="F")
        dataobj = mm
    return NiftiImage(shape, dataobj, slope, inter, bo)


def save(path: str, array: np.ndarray) -> None:
    """Write a float32 NIfTI-1 single file with identity affine."""
    array = np.asarray(array, dtype=np.float32)
    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    dim = [array.ndim] + list(array.shape) + [1] * (7 - array.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[np.dtype(np.float32)])
    struct.pack_into("<h", hdr, 72, 32)             # bitpix
    pixdim = [1.0] * 8
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)          # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)            # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)            # scl_inter
    # sform identity (sform_code=1) so viewers get an affine.
    struct.pack_into("<h", hdr, 254, 1)
    struct.pack_into("<4f", hdr, 280, 1.0, 0.0, 0.0, 0.0)
    struct.pack_into("<4f", hdr, 296, 0.0, 1.0, 0.0, 0.0)
    struct.pack_into("<4f", hdr, 312, 0.0, 0.0, 1.0, 0.0)
    hdr[_MAGIC_OFFSET:_MAGIC_OFFSET + 4] = b"n+1\x00"
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)                         # pad to vox_offset 352
        f.write(np.asfortranarray(array).tobytes(order="F"))
