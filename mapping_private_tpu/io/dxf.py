"""DXF mesh export — `vtk_exporter_service` JAX-framework-native.

Replaces the hand-written writer of vtk_exporter_service/src/dxf_writer.cpp
(1,654 LoC) behind the ObjectSaverService (src/vtk_to_dxf_exporter.cpp:
74-160): triangle meshes are written as DXF R12 3DFACE entities — the
format the reference registered with COP/Halcon as CAD shape models.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def write_dxf_mesh(
    path: str, vertices: np.ndarray, triangles: np.ndarray,
    layer: str = "mesh",
) -> None:
    """Write (V,3) vertices + (T,3) int triangles as DXF 3DFACEs."""
    v = np.asarray(vertices, np.float64)
    t = np.asarray(triangles, np.int64)
    lines = ["0", "SECTION", "2", "ENTITIES"]
    for tri in t:
        a, b, c = v[tri[0]], v[tri[1]], v[tri[2]]
        lines += ["0", "3DFACE", "8", layer]
        for corner_idx, p in enumerate((a, b, c, c)):  # 4th corner repeats
            for axis in range(3):
                lines.append(str(10 + corner_idx + 10 * axis))
                lines.append(f"{p[axis]:.6f}")
    lines += ["0", "ENDSEC", "0", "EOF", ""]
    with open(path, "w") as fp:
        fp.write("\n".join(lines))


def read_dxf_mesh(path: str) -> tuple:
    """Read 3DFACE entities back (round-trip / validation helper).

    Returns (vertices (V,3), triangles (T,3)) with vertices deduplicated.
    """
    tokens = open(path).read().split("\n")
    faces = []
    i = 0
    while i < len(tokens) - 1:
        if tokens[i].strip() == "0" and tokens[i + 1].strip() == "3DFACE":
            corners = {}
            j = i + 2
            while j < len(tokens) - 1:
                code = tokens[j].strip()
                if code == "0":
                    break
                try:
                    ci = int(code)
                except ValueError:
                    j += 2
                    continue
                if 10 <= ci <= 33:
                    corner = ci % 10
                    axis = ci // 10 - 1
                    corners.setdefault(corner, [0.0, 0.0, 0.0])[axis] = float(
                        tokens[j + 1]
                    )
                j += 2
            if all(k in corners for k in (0, 1, 2)):
                faces.append((corners[0], corners[1], corners[2]))
            i = j
        else:
            i += 2
    verts: list = []
    index: dict = {}
    tris = []
    for f in faces:
        ids = []
        for p in f:
            key = tuple(round(x, 6) for x in p)
            if key not in index:
                index[key] = len(verts)
                verts.append(list(key))
            ids.append(index[key])
        tris.append(ids)
    return np.asarray(verts, np.float64), np.asarray(tris, np.int64)
