"""pyblitzdg-compat layer tests: drive the reference's documented Python API
shapes and the reference advec1d.py numpy driver pattern end-to-end."""
import numpy as np
import pytest

from blitzdg_jax import compat as dg


def test_nodes1d_api_shapes():
    p = dg.Nodes1DProvisioner(4, 30, -1.0, 4.0)
    p.buildNodes()
    p.computeJacobian()
    Np = p.numLocalPoints
    assert Np == 5
    assert p.xGrid.shape == (5, 30)  # reference (Np, K)
    assert p.Dr.shape == (5, 5)
    assert p.Lift.shape == (5, 2)
    assert p.vmapM.shape == (60,)


def test_reference_advec1d_numpy_driver():
    """Run the reference's pure-numpy advec1d.py driver pattern
    (/root/reference/advec1d.py:12-39) against the compat API, with
    F-ordered maps, and check the physics matches."""
    p = dg.Nodes1DProvisioner(4, 30, -1.0, 4.0)
    p.buildNodes()
    p.computeJacobian()

    x = p.xGrid
    Dr, rx, Lift, Fscale, nx = p.Dr, p.rx, p.Lift, p.Fscale, p.nx
    vmapM, vmapP = p.vmapM, p.vmapP
    mapI, mapO = p.mapI, p.mapO
    c = 0.1

    def computeRHS(u):
        uVec = u.flatten("F")
        nxVec = nx.flatten("F")
        uM = uVec[vmapM]
        uP = uVec[vmapP].copy()
        uP[mapO] = uM[mapO]
        uP[mapI] = 0.0
        du = (uM - uP) * 0.5 * (c * nxVec - np.abs(c * nxVec))
        duMat = np.reshape(du, (2, 30), order="F")
        RHS = -c * rx * (Dr @ u) + Lift @ (Fscale * duMat)
        return RHS

    u = np.exp(-10.0 * x**2)
    dt = 0.8 * (x[1, 0] - x[0, 0]) / c
    a = dg.LSERK4.rk4a
    b = dg.LSERK4.rk4b
    res = np.zeros_like(u)
    steps = int(np.ceil(20.0 / dt))
    for _ in range(steps):
        for i in range(5):
            rhs = computeRHS(u)
            res = a[i] * res + dt * rhs
            u = u + b[i] * res
    exact = np.exp(-10.0 * (x - c * steps * dt) ** 2)
    err = np.max(np.abs(u - exact))
    assert err < 5e-4, err


def test_mesh_manager_and_triangle_provisioner():
    mesh_path = "/root/reference/input/coarse_box.msh"
    import os

    if not os.path.exists(mesh_path):
        pytest.skip("reference meshes unavailable")
    m = dg.MeshManager()
    m.readMesh(mesh_path)
    assert m.numElements == 40
    assert m.vertices.shape[1] == 3

    m.partitionMesh(4)
    assert m.elementPartitionMap.shape == (40,)
    assert set(np.unique(m.elementPartitionMap)) == {0, 1, 2, 3}

    tri = dg.TriangleNodesProvisioner(2, m)
    tri.buildFilter(1.8, 2)
    ctx = tri.dgContext()
    assert ctx.x.shape == (6, 40)  # (Np, K)
    assert ctx.Fscale.shape == (9, 40)  # (Nfp*Nfaces, K)
    assert ctx.vmapM.shape == (9 * 40,)
    # maps point at physically coincident nodes in reference F-layout
    xF = ctx.x.flatten("F")
    yF = ctx.y.flatten("F")
    np.testing.assert_allclose(xF[ctx.vmapM], xF[ctx.vmapP], atol=1e-9)
    np.testing.assert_allclose(yF[ctx.vmapM], yF[ctx.vmapP], atol=1e-9)
    # BCmap: wall nodes on the domain boundary
    bcmap = ctx.BCmap
    assert dg.BCType.Wall in bcmap


def test_poisson_sparse_matrix_triplets():
    from blitzdg_jax.mesh import box_triangles

    m = dg.MeshManager()
    mesh = box_triangles(4, 4)
    m.buildMesh(mesh.etov, np.concatenate([mesh.verts, 0 * mesh.verts[:, :1]], 1))
    tri = dg.TriangleNodesProvisioner(2, m)
    poisson = dg.Poisson2DSparseMatrix(tri.dgContext(), m)
    OP = poisson.getOP()
    MM = poisson.getMM()
    assert OP.shape[1] == 3 and MM.shape[1] == 3
    import scipy.sparse as sp

    n = 6 * 32
    A = sp.csr_matrix((OP[:, 2], (OP[:, 0].astype(int), OP[:, 1].astype(int))), shape=(n, n))
    assert abs(A - A.T).max() < 1e-8 * abs(A).max()


def test_vtk_outputter(tmp_path):
    import os

    from blitzdg_jax.mesh import box_triangles

    m = dg.MeshManager()
    mesh = box_triangles(2, 2)
    m.buildMesh(mesh.etov, np.concatenate([mesh.verts, 0 * mesh.verts[:, :1]], 1))
    tri = dg.TriangleNodesProvisioner(2, m)
    out = dg.VtkOutputter(tri)
    ctx = tri.dgContext()
    os.chdir(tmp_path)
    out.writeFieldsToFiles({"eta": ctx.x}, 0)
    assert os.path.exists("eta0000000.vtu")


def test_compute_differentiation_matrices():
    """DGContext2D.computeDifferentiationMatrices (reference
    include/DGContext2D.hpp:222-257): physical Dx/Dy at given element
    coords differentiate polynomials exactly."""
    import numpy as np

    from blitzdg_jax import compat

    mm = compat.MeshManager()
    mm.buildMesh(np.array([[0, 1, 2]]),
                 np.array([[0.0, 0.0], [2.0, 0.5], [0.5, 1.5]]))
    nodes = compat.TriangleNodesProvisioner(3, mm)
    ctx = nodes.dgContext()
    x = np.asarray(ctx.x)[:, 0]
    y = np.asarray(ctx.y)[:, 0]
    Dx, Dy = ctx.computeDifferentiationMatrices(x, y)
    f = 2.0 + 3.0 * x - 1.5 * y + 0.25 * x * y
    np.testing.assert_allclose(Dx @ f, 3.0 + 0.25 * y, atol=1e-10)
    np.testing.assert_allclose(Dy @ f, -1.5 + 0.25 * x, atol=1e-10)
