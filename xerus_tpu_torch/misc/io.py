"""Object persistence with the reference's header discipline.

The reference writes ``"Xerus <TypeName> datafile"`` headers followed by a
TSV or binary body (include/xerus/misc/fileIO.h:25, 83-140).  We keep the
same protocol with a ``XerusTPU`` magic; the binary body is a numpy .npz
archive, the text body is TSV.  Type-specific serializers register through
``register_serializer``.  The format is ``xerus_tpu.misc.io``'s byte for
byte, so a file written by either package loads in the other.
"""

from __future__ import annotations

import enum
import io as _io
import json
from typing import Any, Callable, Dict, Tuple

import numpy as np

_MAGIC = "XerusTPU"


class FileFormat(enum.Enum):
    BINARY = 0
    TSV = 1


# type name -> (writer(obj) -> dict[str, np.ndarray|json-able], reader(dict) -> obj)
_SERIALIZERS: Dict[str, Tuple[type, Callable, Callable]] = {}


def register_serializer(type_name: str, cls: type, writer: Callable, reader: Callable) -> None:
    _SERIALIZERS[type_name] = (cls, writer, reader)


def _type_name_of(obj: Any) -> str:
    for name, (cls, _, _) in _SERIALIZERS.items():
        if type(obj) is cls:
            return name
    for name, (cls, _, _) in _SERIALIZERS.items():
        if isinstance(obj, cls):
            return name
    raise TypeError(f"no serializer registered for {type(obj)!r}")


def save_to_file(obj: Any, path: str, file_format: FileFormat = FileFormat.BINARY) -> None:
    name = _type_name_of(obj)
    _, writer, _ = _SERIALIZERS[name]
    payload = writer(obj)
    arrays = {k: np.asarray(v) for k, v in payload.get("arrays", {}).items()}
    meta = payload.get("meta", {})
    header = f"{_MAGIC} {name} datafile\n"
    if file_format is FileFormat.BINARY:
        with open(path, "wb") as f:
            f.write(header.encode())
            f.write(b"BINARY\n")
            f.write((json.dumps(meta) + "\n").encode())
            buf = _io.BytesIO()
            np.savez(buf, **arrays)
            f.write(buf.getvalue())
    else:
        with open(path, "w") as f:
            f.write(header)
            f.write("TSV\n")
            f.write(json.dumps(meta) + "\n")
            for k in sorted(arrays):
                arr = arrays[k]
                f.write(f"{k}\t{arr.dtype.str}\t{json.dumps(list(arr.shape))}\n")
                flat = arr.reshape(-1)
                f.write("\t".join(repr(float(x)) if arr.dtype.kind == "f" else str(int(x))
                                  for x in flat))
                f.write("\n")


def load_from_file(path: str) -> Any:
    with open(path, "rb") as f:
        header = f.readline().decode().strip()
        parts = header.split()
        if len(parts) != 3 or parts[0] != _MAGIC or parts[2] != "datafile":
            raise ValueError(f"not a {_MAGIC} datafile: {header!r}")
        name = parts[1]
        if name not in _SERIALIZERS:
            raise ValueError(f"unknown datafile type {name!r}")
        _, _, reader = _SERIALIZERS[name]
        body_format = f.readline().decode().strip()
        meta = json.loads(f.readline().decode())
        if body_format == "BINARY":
            data = np.load(_io.BytesIO(f.read()))
            arrays = {k: data[k] for k in data.files}
        elif body_format == "TSV":
            arrays = {}
            text = f.read().decode()
            lines = [ln for ln in text.split("\n") if ln.strip()]
            i = 0
            while i < len(lines):
                key, dtype_str, shape_json = lines[i].split("\t")
                shape = tuple(json.loads(shape_json))
                vals = lines[i + 1].split("\t") if int(np.prod(shape)) else []
                arr = np.array([float(v) for v in vals], dtype=np.dtype(dtype_str))
                arrays[key] = arr.reshape(shape)
                i += 2
        else:
            raise ValueError(f"unknown body format {body_format!r}")
    return reader({"arrays": arrays, "meta": meta})
