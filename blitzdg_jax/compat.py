"""pyblitzdg-compatible API surface.

Drop-in-style class wrappers over the JAX core covering the public
API of the reference's Python bindings (src/pyblitzdg/pyblitzdg.cpp:52-199,
SURVEY.md §2.6): Nodes1DProvisioner, MeshManager, TriangleNodesProvisioner,
QuadNodesProvisioner, VandermondeBuilder, LSERK4, DGContext2D property
accessors, Poisson2DSparseMatrix, VtkOutputter, and the BCType constants.

Array conventions: the reference returns (Np, K) column-major fields; these
wrappers return the same shapes (transposing the framework's element-major
(K, Np) layout) and flat F-ordered index maps, so scripts written against
pyblitzdg keep working. New code should use the element-major core API
directly.
"""
from __future__ import annotations

import numpy as np

from .context import BC_DIRICHLET, BC_NEUMAN, BC_WALL


class BCType:
    """Reference include/BCtypes.hpp:9-18."""

    In = 1
    Out = 2
    Wall = 3
    Far = 4
    Cyl = 5
    Dirichlet = 6
    Neuman = 7
    Slip = 8


class LSERK4:
    """Reference include/LSERK4.hpp:16-27."""

    from .timestepping import LSERK4_A as _a, LSERK4_B as _b

    numStages = 5
    rk4a = np.asarray(_a)
    rk4b = np.asarray(_b)


class VandermondeBuilder:
    """Reference pyblitzdg.cpp:92-94."""

    def buildVandermondeMatrix(self, r, includeInverse: bool, order: int):
        from .specgrid.vandermonde import vandermonde_1d

        V = vandermonde_1d(order, np.asarray(r, dtype=np.float64))
        if includeInverse:
            return V, np.linalg.inv(V)
        return (V,)


class MeshManager:
    """Reference pyblitzdg.cpp:101-111."""

    def __init__(self):
        self._mesh = None
        self._element_partition = None
        self._vertex_partition = None

    def readMesh(self, path: str):
        from .mesh import read_gmsh

        self._mesh = read_gmsh(path)

    def buildMesh(self, EToV, Vertices):
        from .mesh import build_mesh

        self._mesh = build_mesh(np.asarray(Vertices), np.asarray(EToV))

    def readVertices(self, path: str):
        """CSV vertex reader (reference MeshManager.cpp:546-552)."""
        from .io.csv import csvread

        self._csv_verts = csvread(path, float)[:, :2]
        self._maybe_build_csv()

    def readElements(self, path: str):
        """CSV element reader (reference MeshManager.cpp:554-562)."""
        from .io.csv import csvread

        self._csv_elems = csvread(path, float).astype(np.int64)
        self._maybe_build_csv()

    def _maybe_build_csv(self):
        if getattr(self, "_csv_verts", None) is not None and \
                getattr(self, "_csv_elems", None) is not None:
            from .mesh import build_mesh

            self._mesh = build_mesh(self._csv_verts, self._csv_elems)

    def partitionMesh(self, numPartitions: int):
        from .parallel.partition import rcb_partition

        cent = self._mesh.verts[self._mesh.etov].mean(axis=1)
        self._element_partition = rcb_partition(cent, numPartitions)
        # vertex partition: owner of the first touching element
        vp = np.zeros(self._mesh.num_verts, dtype=np.int32)
        for k in range(self._mesh.num_elements - 1, -1, -1):
            vp[self._mesh.etov[k]] = self._element_partition[k]
        self._vertex_partition = vp

    def setBCType(self, bcType):
        self._mesh.set_bc_type(np.asarray(bcType))

    @property
    def numElements(self):
        return self._mesh.num_elements

    @property
    def elements(self):
        return self._mesh.etov

    @property
    def vertices(self):
        v = self._mesh.verts
        return np.concatenate([v, np.zeros((v.shape[0], 1))], axis=1)

    @property
    def bcType(self):
        return self._mesh.bc_type

    @property
    def elementPartitionMap(self):
        return self._element_partition

    @property
    def vertexPartitionMap(self):
        return self._vertex_partition


class _ContextView:
    """Reference DGContext2D property surface (pyblitzdg.cpp:160-187),
    reference shapes: fields (Np, K), face data (Nfp*Nfaces, K)."""

    def __init__(self, ctx):
        self._ctx = ctx

    def computeDifferentiationMatrices(self, x, y):
        """Physical differentiation matrices (Dx, Dy), each (Np, Np), at
        the given single-element nodal coordinates x, y (Np,) — reference
        DGContext2D::computeDifferentiationMatrices
        (include/DGContext2D.hpp:222-257): metric from Dr/Ds applied to
        the coords, then Dx = rx*Dr + sx*Ds row-scaled per node."""
        Dr = np.asarray(self._ctx.Dr)
        Ds = np.asarray(self._ctx.Ds)
        x = np.asarray(x).reshape(-1)
        y = np.asarray(y).reshape(-1)
        xr, xs = Dr @ x, Ds @ x
        yr, ys = Dr @ y, Ds @ y
        J = -xs * yr + xr * ys
        rx, sx = ys / J, -yr / J
        ry, sy = -xs / J, xr / J
        Dx = rx[:, None] * Dr + sx[:, None] * Ds
        Dy = ry[:, None] * Dr + sy[:, None] * Ds
        return Dx, Dy

    # static
    @property
    def numLocalPoints(self):
        return self._ctx.n_p

    @property
    def numElements(self):
        return self._ctx.k_elem

    @property
    def numFaces(self):
        return self._ctx.n_faces

    @property
    def numFacePoints(self):
        return self._ctx.n_fp

    @property
    def order(self):
        return self._ctx.n_order

    # reference-element operators (already reference-shaped)
    @property
    def r(self):
        return np.asarray(self._ctx.r)

    @property
    def s(self):
        return np.asarray(self._ctx.s)

    @property
    def V(self):
        return np.asarray(self._ctx.V)

    @property
    def Vinv(self):
        return np.asarray(self._ctx.Vinv)

    @property
    def Dr(self):
        return np.asarray(self._ctx.Dr)

    @property
    def Ds(self):
        return np.asarray(self._ctx.Ds)

    @property
    def Drw(self):
        return np.asarray(self._ctx.Drw)

    @property
    def Dsw(self):
        return np.asarray(self._ctx.Dsw)

    @property
    def Lift(self):
        return np.asarray(self._ctx.lift)

    @property
    def Filter(self):
        return np.asarray(self._ctx.filter)

    @property
    def Fmask(self):
        return np.asarray(self._ctx.fmask).T  # reference: (Nfp, Nfaces)

    # per-element fields -> reference (Np, K)
    def _field(self, a):
        return np.asarray(a).T

    x = property(lambda self: self._field(self._ctx.x))
    y = property(lambda self: self._field(self._ctx.y))
    jacobian = property(lambda self: self._field(self._ctx.J))
    rx = property(lambda self: self._field(self._ctx.rx))
    ry = property(lambda self: self._field(self._ctx.ry))
    sx = property(lambda self: self._field(self._ctx.sx))
    sy = property(lambda self: self._field(self._ctx.sy))
    nx = property(lambda self: self._field(self._ctx.nx))
    ny = property(lambda self: self._field(self._ctx.ny))
    Fscale = property(lambda self: self._field(self._ctx.fscale))

    @property
    def vmapM(self):
        """Flat F-ordered (column-major (Nfp*Nfaces, K)) volume indices into
        F-ordered (Np, K) fields — the reference's layout."""
        return self._to_ref_map(self._ctx.vmapM)

    @property
    def vmapP(self):
        return self._to_ref_map(self._ctx.vmapP)

    def _to_ref_map(self, m):
        # ours: (K, Nfaces*Nfp) row-major flat into (K*Np,). Reference:
        # volume id = node + Np*k (F-order of (Np, K)), and the trace
        # sequence iterates (n, f) within each element k — which is exactly
        # the row-major flattening of our (K, ntr) table.
        ctx = self._ctx
        m = np.asarray(m)  # (K, ntr)
        k = m // ctx.n_p
        node = m % ctx.n_p
        return (node + ctx.n_p * k).reshape(-1)

    @property
    def BCmap(self):
        """tag -> array of flat F-ordered trace indices."""
        ctx = self._ctx
        out = {}
        bc = np.asarray(ctx.bc_table)
        K, Nf = bc.shape
        nfp = ctx.n_fp
        for tag in np.unique(bc):
            if tag == 0:
                continue
            faces = np.argwhere(bc == tag)
            # reference flat index: node + f*Nfp + k*Nfaces*Nfp, F-ordered
            # over (Nfp*Nfaces, K) == our (k, f, node) -> node+f*nfp sorted
            # by k last; F-order flat = (node + f*nfp) + k*(Nf*nfp)... the
            # reference flattens (Nfp*Nfaces, K) F-order: idx = row + col*
            # (Nfp*Nfaces) with row = f*Nfp+node, col = k
            rows = (faces[:, 1][:, None] * nfp + np.arange(nfp)[None, :]).ravel()
            cols = np.repeat(faces[:, 0], nfp)
            out[int(tag)] = rows + cols * (Nf * nfp)
        return out


class TriangleNodesProvisioner:
    """Reference pyblitzdg.cpp:113-118."""

    def __init__(self, NOrder: int, meshManager: MeshManager):
        self._order = NOrder
        self._mesh = meshManager._mesh
        self._filter = (None, 4)
        self._coords = None
        self._build()

    def _build(self):
        from .specgrid.triangle import build_triangle_context

        cutoff, forder = self._filter
        self._ctx = build_triangle_context(
            self._order,
            self._mesh,
            dtype=None,
            filter_cutoff=cutoff,
            filter_order=forder,
            coords=self._coords,
        )

    def buildFilter(self, Nc: float, s: int):
        self._filter = (Nc, s)
        self._build()

    def setCoordinates(self, x, y):
        # reference shape (Np, K) -> element-major
        self._coords = (np.asarray(x).T, np.asarray(y).T)
        self._build()

    def buildCubatureVolumeMesh(self, NCubature: int):
        from .specgrid.cubature import build_cubature_context

        self._cub = build_cubature_context(
            self._order, self._mesh, self._ctx.x, self._ctx.y, self._ctx.V,
            order=NCubature, dtype=None,
        )
        return self._cub

    def buildGaussFaceNodes(self, NGauss: int):
        from .specgrid.cubature import build_gauss_face_context

        self._gauss = build_gauss_face_context(
            self._order, self._mesh, self._ctx.x, self._ctx.y, self._ctx.V,
            n_gauss=NGauss, dtype=None,
        )
        return self._gauss

    def dgContext(self):
        return _ContextView(self._ctx)


class QuadNodesProvisioner:
    """Reference pyblitzdg.cpp:120-122."""

    def __init__(self, NOrder: int, meshManager: MeshManager):
        from .specgrid.quad import build_quad_context

        self._order = NOrder
        self._mesh = meshManager._mesh
        self._ctx = build_quad_context(NOrder, self._mesh, dtype=None)

    def buildFilter(self, Nc: float, s: int):
        from .specgrid.quad import build_quad_context

        self._ctx = build_quad_context(
            self._order, self._mesh, dtype=None, filter_cutoff=Nc, filter_order=s
        )

    def dgContext(self):
        return _ContextView(self._ctx)


class Nodes1DProvisioner:
    """Reference pyblitzdg.cpp:66-81."""

    def __init__(self, NOrder: int, K: int, xLeft: float, xRight: float):
        self._args = (NOrder, K, xLeft, xRight)
        self._ctx = None

    def buildNodes(self):
        from .specgrid.nodes1d import build_nodes1d

        self._ctx = build_nodes1d(*self._args, dtype=None)

    def computeJacobian(self):
        if self._ctx is None:
            self.buildNodes()

    @property
    def numLocalPoints(self):
        return self._ctx.n_p

    @property
    def xGrid(self):
        return np.asarray(self._ctx.x).T

    @property
    def Dr(self):
        return np.asarray(self._ctx.Dr)

    @property
    def rx(self):
        return np.asarray(self._ctx.rx).T

    @property
    def Fscale(self):
        return np.asarray(self._ctx.fscale).T

    @property
    def Lift(self):
        return np.asarray(self._ctx.lift)

    @property
    def nx(self):
        return np.asarray(self._ctx.nx).T

    @property
    def vmapM(self):
        c = self._ctx
        m = np.asarray(c.vmapM)
        return (m % c.n_p + c.n_p * (m // c.n_p)).reshape(-1)

    @property
    def vmapP(self):
        c = self._ctx
        m = np.asarray(c.vmapP)
        return (m % c.n_p + c.n_p * (m // c.n_p)).reshape(-1)

    @property
    def mapI(self):
        return self._ctx.mapI

    @property
    def mapO(self):
        # reference F-order trace numbering: (f + k*Nfaces) -> same total
        return 2 * self._ctx.k_elem - 1

    @property
    def vmapI(self):
        return 0

    @property
    def vmapO(self):
        return self._ctx.n_p * self._ctx.k_elem - 1


class Poisson2DSparseMatrix:
    """Reference pyblitzdg.cpp:194-199: assembled SIP operator exposed as
    (nnz, 3) triplets."""

    def __init__(self, dgContext: _ContextView, meshManager: MeshManager,
                 bordered: bool = False, skipDG: bool = False,
                 gaussFaceContext=None, cubatureContext=None):
        """Nodal path by default; passing the Gauss-face + cubature contexts
        selects the CURVED cubature/Gauss SIP assembly — the reference's
        curved ctor overload (pyblitzdg.cpp:194-199 ->
        Poisson2DSparseMatrix.cpp:37-317)."""
        from .ops.poisson import assemble_poisson2d, assemble_poisson2d_curved
        from .ops.sem import assemble_sem_poisson

        ctx = dgContext._ctx
        if gaussFaceContext is not None or cubatureContext is not None:
            assert gaussFaceContext is not None and cubatureContext is not None
            gauss = getattr(gaussFaceContext, "_gauss", gaussFaceContext)
            cub = getattr(cubatureContext, "_cub", cubatureContext)
            self._OP, self._MM = assemble_poisson2d_curved(
                ctx, cub, gauss, bordered=bordered)
        elif skipDG:
            self._OP, self._MM = assemble_sem_poisson(ctx)
        else:
            self._OP, self._MM = assemble_poisson2d(ctx, bordered=bordered)
        self._ctx = ctx

    def buildBcRhs(self, dgContext, meshManager, ubc, qbc):
        from .ops.poisson import assemble_bc_rhs

        ctx = self._ctx
        # reference shapes: (Nfp*Nfaces, K) -> (K, ntr)
        b = assemble_bc_rhs(ctx, np.asarray(ubc).T, np.asarray(qbc).T)
        return b.T  # (Np, K)

    def _triplets(self, A):
        coo = A.tocoo()
        return np.stack([coo.row, coo.col, coo.data], axis=1)

    def getOP(self):
        return self._triplets(self._OP)

    def getMM(self):
        return self._triplets(self._MM)


class VtkOutputter:
    """Reference pyblitzdg.cpp:189-192."""

    def __init__(self, provisioner):
        self._ctx = provisioner._ctx

    def generateFileName(self, base: str, index: int) -> str:
        from .io.vtk import generate_file_name

        return generate_file_name(base, index)

    def writeFieldToFile(self, fileName: str, field, fieldName: str = "field"):
        from .io.vtk import write_vtu

        write_vtu(fileName, self._ctx, {fieldName: np.asarray(field).T})

    def writeFieldsToFiles(self, fields: dict, index: int):
        from .io.vtk import write_fields_to_files

        write_fields_to_files(
            self._ctx, {k: np.asarray(v).T for k, v in fields.items()}, index
        )
