"""Minimal mesh loading for the renderer demo's mesh branch.

Counterpart of sdflabel_tpu/utils/meshio.py (numpy only, as there). The
reference's `render_model` (sdfrenderer/main.py:13-59) loads meshes via
trimesh, an optional dependency. This module provides the demo's needs
natively: a small Wavefront OBJ parser
(vertices, optional per-vertex RGB extension, vertex normals — computed
area-weighted from faces when the file carries none) plus the npz layout
used by the bundled demo assets. trimesh, when installed, still handles
every other format (render_demo.render_model tries it for non-.obj).
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """Parse a Wavefront OBJ into (vertices, normals, colors).

    Supports:
      * `v x y z [r g b]` — the common per-vertex-color extension; colors
        default to mid-gray when absent (the reference demo only needs
        *some* per-vertex color to splat, main.py:30-33);
      * `vn nx ny nz` resolved through the face rows' `v//vn` index
        mapping (shared/reordered normals land on the right vertices);
        positional vertex/vn pairing only when no face carries a vn
        index and the counts match; otherwise normals are computed
        area-weighted from `f` rows (fan-triangulated, indices 1-based,
        `v/vt/vn` forms accepted).
    """
    verts, vns, colors, faces = [], [], [], []
    vn_pairs = []  # (vertex index, vn index) from face corners
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                vals = [float(x) for x in parts[1:]]
                verts.append(vals[:3])
                colors.append(vals[3:6] if len(vals) >= 6 else None)
            elif parts[0] == "vn":
                vns.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = []
                for tok in parts[1:]:
                    fields = tok.split("/")
                    i = int(fields[0])
                    i = i - 1 if i > 0 else len(verts) + i
                    idx.append(i)
                    if len(fields) >= 3 and fields[2]:
                        j = int(fields[2])
                        vn_pairs.append((i, j - 1 if j > 0
                                         else len(vns) + j))
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))

    v = np.asarray(verts, np.float64)
    if len(v) == 0:
        raise ValueError(f"{path}: no vertices")

    if vn_pairs and vns:
        # accumulate each referenced vn onto its vertex (per-vertex
        # normals: all corners agree; shared normals: averaged)
        vn_arr = np.asarray(vns, np.float64)
        n = np.zeros_like(v)
        pairs = np.asarray(vn_pairs, np.int64)
        ok = (pairs[:, 1] >= 0) & (pairs[:, 1] < len(vn_arr))
        pairs = pairs[ok]
        np.add.at(n, pairs[:, 0], vn_arr[pairs[:, 1]])
    elif len(vns) == len(v) and len(v) > 0:
        n = np.asarray(vns, np.float64)
    elif faces:
        n = np.zeros_like(v)
        fa = np.asarray(faces, np.int64)
        cross = np.cross(v[fa[:, 1]] - v[fa[:, 0]], v[fa[:, 2]] - v[fa[:, 0]])
        for col in range(3):  # accumulate area-weighted face normals
            np.add.at(n, fa[:, col], cross)
    else:
        n = np.tile([0.0, 0.0, 1.0], (len(v), 1))
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(norm > 0, n / np.maximum(norm, 1e-30), [0.0, 0.0, 1.0])

    if all(c is not None for c in colors):
        c = np.asarray(colors, np.float64)
    else:
        c = np.full((len(v), 3), 0.5)
    return (v.astype(np.float32), n.astype(np.float32),
            np.clip(c, 0.0, 1.0).astype(np.float32))


def load_mesh(path: str):
    """(vertices, normals, colors) for render_model's mesh branch.

    Dispatch: .npz bundled-asset layout; .obj via the native parser;
    anything else through trimesh (optional dependency). Vertices are
    normalized by their max exactly as the reference does for trimesh
    loads (sdfrenderer/main.py:36).
    """
    if path.endswith(".npz"):
        data = np.load(path)
        return data["vertices"], data["normals"], data["colors"]
    if path.endswith(".obj"):
        verts, normals, colors = load_obj(path)
        verts = verts / max(float(verts.max()), 1e-30)
        return verts, normals, colors
    import trimesh  # optional; .npz/.obj paths need no extra deps

    mesh = trimesh.load(path)
    verts = np.asarray(mesh.vertices) / np.asarray(mesh.vertices).max()
    normals = np.asarray(mesh.vertex_normals)
    colors = np.asarray(mesh.visual.vertex_colors[:, :3]) / 255.0
    return (verts.astype(np.float32), normals.astype(np.float32),
            colors.astype(np.float32))
