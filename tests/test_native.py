"""Native C++ mesh-runtime kernels vs. numpy reference implementations."""
import numpy as np
import pytest

from blitzdg_jax import native
from blitzdg_jax.mesh import box_triangles, box_quads
from blitzdg_jax.mesh.connectivity import build_connectivity as np_connectivity
from blitzdg_jax.specgrid.triangle import _build_maps, build_fmask, triangle_nodes

pytestmark = pytest.mark.skipif(not native.available(), reason="no native toolchain")


def test_connectivity_matches_numpy():
    for mesh in [box_triangles(5, 7), box_quads(4, 6)]:
        etoe_np, etof_np = np_connectivity(mesh.etov)
        etoe_c, etof_c = native.build_connectivity(mesh.etov)
        np.testing.assert_array_equal(etoe_c, etoe_np)
        np.testing.assert_array_equal(etof_c, etof_np)


def test_maps_match_numpy():
    mesh = box_triangles(4, 5)
    N = 3
    r, s = triangle_nodes(N)
    fmask = build_fmask(r, s, N + 1)
    # physical nodes via the vertex blend (same as the context builder)
    va, vb, vc = mesh.etov[:, 0], mesh.etov[:, 1], mesh.etov[:, 2]
    VX, VY = mesh.verts[:, 0], mesh.verts[:, 1]
    lam = np.stack([-(r + s), 1.0 + r, 1.0 + s], axis=0) * 0.5
    x = lam[0][None, :] * VX[va][:, None] + lam[1][None, :] * VX[vb][:, None] + lam[2][None, :] * VX[vc][:, None]
    y = lam[0][None, :] * VY[va][:, None] + lam[1][None, :] * VY[vb][:, None] + lam[2][None, :] * VY[vc][:, None]

    vm_np, vp_np, mp_np = _build_maps(x, y, fmask, mesh, x.shape[1])
    out = native.build_maps(x, y, fmask, mesh.etoe, mesh.etof, mesh.verts, mesh.etov)
    assert out is not None
    vm_c, vp_c, mp_c = out
    np.testing.assert_array_equal(vm_c, vm_np)
    np.testing.assert_array_equal(vp_c, vp_np)
    np.testing.assert_array_equal(mp_c, mp_np)


def test_gmsh_parse_matches_python():
    import os

    path = "/root/reference/input/coarse_box.msh"
    if not os.path.exists(path):
        pytest.skip("reference meshes unavailable")
    text = open(path).read()
    out = native.parse_gmsh_elements(text)
    assert out is not None
    tris, quads, lines, tags = out
    assert tris.shape == (40, 3)
    assert quads.shape[0] == 0
    from blitzdg_jax.mesh import read_gmsh

    mesh = read_gmsh(path)
    # read_gmsh applies CCW re-orientation; compare as vertex sets
    a = {tuple(sorted(r)) for r in tris.tolist()}
    b = {tuple(sorted(r)) for r in mesh.etov.tolist()}
    assert a == b
