"""Minimal PLY mesh reader (vertices + faces), no external deps (the port's
copy of checkerpose_tpu/data/ply.py).

Replaces the reference's `plyfile` dependency (used at
`preprocess_data/get_fps_points.py`) and bop_toolkit's `inout.load_ply`
(`bop_toolkit_lib/inout.py:66`) for the vertex data the framework needs
(FPS keypoints, ADD/ADI vertex sets). Supports ascii and
binary_little_endian, float/double properties.
"""
from __future__ import annotations

import numpy as np

_DTYPES = {
    "float": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64,
    "uchar": np.uint8, "uint8": np.uint8, "char": np.int8,
    "short": np.int16, "ushort": np.uint16,
    "int": np.int32, "int32": np.int32, "uint": np.uint32,
}


def load_ply_vertices(path: str) -> np.ndarray:
    """Return (N, 3) float64 vertex positions (one parser: the vertex half
    of `load_ply_mesh` -- keeping two copies of the header/decode logic let
    them drift)."""
    return load_ply_mesh(path)[0]


def load_ply_mesh(path: str):
    """(verts (V,3) float64, faces (F,3) int32). Quads are fan-triangulated.

    Face support for the depth renderer (eval/renderer.py); the reference
    gets this from bop_toolkit `inout.load_ply` (bop_toolkit_lib/inout.py:66).
    """
    with open(path, "rb") as f:
        fmt = None
        counts = {}
        props = []
        cur_elem = None
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                counts[name] = int(cnt)
                cur_elem = name
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    props.append((cur_elem, parts[-1], ("list", parts[2], parts[3])))
                else:
                    props.append((cur_elem, parts[2], parts[1]))
            elif line == "end_header":
                break
            elif line == "":
                raise ValueError(f"unexpected EOF in PLY header: {path}")

        nv = counts.get("vertex", 0)
        nf = counts.get("face", 0)
        vprops = [(n, t) for e, n, t in props if e == "vertex"]
        tris = []

        if fmt == "ascii":
            rows = [f.readline().split() for _ in range(nv)]
            arr = np.array(rows, np.float64)
            cols = {n: i for i, (n, _) in enumerate(vprops)}
            verts = arr[:, [cols["x"], cols["y"], cols["z"]]]
            for _ in range(nf):
                parts = f.readline().split()
                k = int(parts[0])
                idx = [int(p) for p in parts[1:1 + k]]
                for j in range(1, k - 1):  # fan triangulation
                    tris.append((idx[0], idx[j], idx[j + 1]))
            return verts, np.asarray(tris, np.int32).reshape(-1, 3)

        if fmt != "binary_little_endian":
            raise NotImplementedError(f"PLY format {fmt}")
        dt = np.dtype([(n, _DTYPES[t].__name__) for n, t in vprops
                       if not isinstance(t, tuple)])
        raw = np.frombuffer(f.read(dt.itemsize * nv), dtype=dt, count=nv)
        verts = np.stack([raw["x"], raw["y"], raw["z"]], axis=1).astype(np.float64)
        fprops = [t for e, n, t in props if e == "face" and isinstance(t, tuple)]
        cnt_dt = np.dtype(_DTYPES[fprops[0][1]]) if fprops else np.dtype(np.uint8)
        idx_dt = np.dtype(_DTYPES[fprops[0][2]]) if fprops else np.dtype(np.int32)
        buf = f.read()
        off = 0
        for _ in range(nf):
            k = int(np.frombuffer(buf, cnt_dt, 1, off)[0])
            off += cnt_dt.itemsize
            idx = np.frombuffer(buf, idx_dt, k, off)
            off += k * idx_dt.itemsize
            for j in range(1, k - 1):
                tris.append((int(idx[0]), int(idx[j]), int(idx[j + 1])))
        return verts, np.asarray(tris, np.int32).reshape(-1, 3)


def save_ply_vertices(path: str, verts: np.ndarray, faces: np.ndarray | None = None):
    """Write a minimal ascii PLY (used by the synthetic dataset fixture)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if faces is not None:
            f.write(f"element face {len(faces)}\n")
            f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for v in verts:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        if faces is not None:
            for face in faces:
                f.write(f"{len(face)} " + " ".join(str(int(i)) for i in face) + "\n")
