"""Binary PLY reader/writer, a copy of ssdr_al_tpu/data/ply.py.

Same artifact format as the reference's helper_ply.py (P9 in SURVEY.md:
`read_ply` at helper_ply.py:92, `write_ply` at helper_ply.py:193): little-endian
binary PLY with named scalar properties. Files written here are readable by the
reference and vice versa — the on-disk dataset artifacts (original_ply/,
input_<grid>/) stay interchangeable.
"""

from __future__ import annotations

import numpy as np

# PLY type name ↔ numpy dtype (binary little-endian)
_PLY_TO_NP = {
    "int8": "i1", "char": "i1",
    "uint8": "u1", "uchar": "u1",
    "int16": "i2", "short": "i2",
    "uint16": "u2", "ushort": "u2",
    "int32": "i4", "int": "i4",
    "uint32": "u4", "uint": "u4",
    "float32": "f4", "float": "f4",
    "float64": "f8", "double": "f8",
}
_NP_TO_PLY = {
    "int8": "char", "uint8": "uchar",
    "int16": "short", "uint16": "ushort",
    "int32": "int", "uint32": "uint",
    "float32": "float", "float64": "double",
}


def read_ply(path):
    """Read a binary PLY file → structured numpy array keyed by property name.

    Matches the access pattern of the reference (`data['x']`, `data['class']`,
    s3dis_dataset.py:92-93).
    """
    with open(path, "rb") as f:
        line = f.readline().decode().strip()
        if line != "ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        num_points = None
        props = []
        while True:
            line = f.readline().decode().strip()
            if line == "end_header":
                break
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                if parts[1] != "vertex":
                    raise ValueError(f"{path}: only vertex elements supported")
                num_points = int(parts[2])
            elif parts[0] == "property":
                if parts[1] == "list":
                    raise ValueError(f"{path}: list properties not supported")
                props.append((parts[2], _PLY_TO_NP[parts[1]]))
        if fmt != "binary_little_endian":
            raise ValueError(f"{path}: format {fmt!r} not supported")
        dtype = np.dtype([(name, "<" + t) for name, t in props])
        data = np.frombuffer(f.read(num_points * dtype.itemsize), dtype=dtype)
    return data


def write_ply(path, field_list, field_names):
    """Write binary PLY. field_list: array or list of arrays (columns are
    split across names); field_names: one name per total column.

    Mirrors helper_ply.write_ply:193's calling convention:
        write_ply(p, [xyz, colors, labels], ['x','y','z','red','green','blue','class'])
    """
    if not isinstance(field_list, (list, tuple)):
        field_list = [field_list]
    columns = []
    for field in field_list:
        field = np.asarray(field)
        if field.ndim == 1:
            columns.append(field)
        else:
            for c in range(field.shape[1]):
                columns.append(np.ascontiguousarray(field[:, c]))
    if len(columns) != len(field_names):
        raise ValueError(
            f"{len(columns)} columns but {len(field_names)} names"
        )
    n = len(columns[0])
    if any(len(c) != n for c in columns):
        raise ValueError("column length mismatch")

    dtype = np.dtype(
        [(name, columns[i].dtype.str) for i, name in enumerate(field_names)]
    )
    rec = np.empty(n, dtype=dtype)
    for name, col in zip(field_names, columns):
        rec[name] = col

    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}"]
        for i, name in enumerate(field_names):
            ply_t = _NP_TO_PLY[columns[i].dtype.name]
            header.append(f"property {ply_t} {name}")
        header.append("end_header")
        f.write(("\n".join(header) + "\n").encode())
        f.write(rec.tobytes())
    return True
