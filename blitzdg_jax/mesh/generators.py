"""Structured mesh generators (standalone test/benchmark fixtures).

The reference ships static Gmsh fixtures (input/box.msh etc.); this
framework generates equivalent meshes programmatically so workloads scale
parametrically (element counts are a first-class throughput knob).
"""
from __future__ import annotations

import numpy as np

from ..context import BC_WALL
from .gmsh import Mesh2D, build_mesh


def box_triangles(nx: int, ny: int, xlim=(-1.0, 1.0), ylim=(-1.0, 1.0),
                  default_bc: int = BC_WALL) -> Mesh2D:
    """Uniform triangulated rectangle: nx*ny cells, 2 triangles each
    (K = 2*nx*ny)."""
    xs = np.linspace(*xlim, nx + 1)
    ys = np.linspace(*ylim, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    tris = []
    for i in range(nx):
        for j in range(ny):
            v00, v10 = vid(i, j), vid(i + 1, j)
            v01, v11 = vid(i, j + 1), vid(i + 1, j + 1)
            # split along the cell diagonal, alternating for isotropy
            if (i + j) % 2 == 0:
                tris.append([v00, v10, v11])
                tris.append([v00, v11, v01])
            else:
                tris.append([v00, v10, v01])
                tris.append([v10, v11, v01])
    return build_mesh(verts, np.asarray(tris, dtype=np.int32), default_bc)


def box_quads(nx: int, ny: int, xlim=(-1.0, 1.0), ylim=(-1.0, 1.0),
              default_bc: int = BC_WALL) -> Mesh2D:
    """Uniform quadrilateral rectangle mesh (K = nx*ny)."""
    xs = np.linspace(*xlim, nx + 1)
    ys = np.linspace(*ylim, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    quads = []
    for i in range(nx):
        for j in range(ny):
            quads.append([vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)])
    return build_mesh(verts, np.asarray(quads, dtype=np.int32), default_bc)


def disk_triangles(n_rings: int, radius: float = 1.0,
                   default_bc: int = BC_WALL) -> Mesh2D:
    """Unstructured-ish triangulated disk: concentric rings of vertices
    triangulated ring-to-ring (curved-boundary test domain, analog of the
    reference's R_8km_circle workload)."""
    verts = [(0.0, 0.0)]
    ring_start = [0, 1]
    for r in range(1, n_rings + 1):
        n_pts = 6 * r
        rad = radius * r / n_rings
        ang = 2 * np.pi * np.arange(n_pts) / n_pts
        verts.extend(zip(rad * np.cos(ang), rad * np.sin(ang)))
        ring_start.append(ring_start[-1] + n_pts)
    verts = np.asarray(verts)

    tris = []
    # innermost ring around the center vertex
    s1 = ring_start[1]
    for t in range(6):
        tris.append([0, s1 + t, s1 + (t + 1) % 6])
    # ring r-1 (inner, 6(r-1) pts) to ring r (outer, 6r pts)
    for r in range(2, n_rings + 1):
        si, ni = ring_start[r - 1], 6 * (r - 1)
        so, no = ring_start[r], 6 * r
        # walk both rings by angle, advancing whichever lags
        ti = to = 0
        while ti < ni or to < no:
            ang_i = (ti + 1) / ni if ti < ni else np.inf
            ang_o = (to + 1) / no if to < no else np.inf
            vi, vo = si + ti % ni, so + to % no
            if ang_o <= ang_i:
                tris.append([vo, so + (to + 1) % no, vi])
                to += 1
            else:
                tris.append([vi, vo, si + (ti + 1) % ni])
                ti += 1
    return build_mesh(verts, np.asarray(tris, dtype=np.int32), default_bc)
