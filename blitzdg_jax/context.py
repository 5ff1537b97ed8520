"""Device-resident DG contexts: immutable pytrees of static-shaped arrays.

The JAX analog of the reference's DGContext2D value object
(/root/reference/include/DGContext2D.hpp:9-259), re-designed element-major:
per-node fields are `(K, Np)` (row-major, element index leading so XLA can
tile/shard the element axis), per-face-node fields are `(K, Nfaces*Nfp)`,
reference-element operators are `(Np, Np)` / `(Np, Nfaces*Nfp)` and are
shared by every element (broadcast via one batched matmul).

All index maps are precomputed int32 arrays (built once on host):
 - ``vmapM``/``vmapP``: flat indices into a flattened `(K*Np,)` volume field,
   shaped `(K, Nfaces*Nfp)` — the interface trace-exchange pattern
   (reference: TriangleNodesProvisioner.cpp:895-1020).
 - ``mapP``: flat indices into the flattened `(K*Nfaces*Nfp,)` *trace* array.
   This is the form halo exchange uses on a sharded element axis: traces are
   exchanged, then gathered by ``mapP`` — volume data never moves.
 - Boundary-condition node lists are fixed-size padded index arrays + counts
   (ragged→static for XLA), replacing the reference's tag→vector hash
   (TriangleNodesProvisioner.cpp:1022-1057).
"""
from __future__ import annotations

from typing import Any

import jax.numpy as jnp
import numpy as np

from . import struct

# Boundary-condition tags (reference: include/BCtypes.hpp:9-18).
BC_NONE = 0
BC_IN = 1
BC_OUT = 2
BC_WALL = 3
BC_FAR = 4
BC_CYL = 5
BC_DIRICHLET = 6
BC_NEUMAN = 7
BC_SLIP = 8
BC_TAGS = (BC_IN, BC_OUT, BC_WALL, BC_FAR, BC_CYL, BC_DIRICHLET, BC_NEUMAN, BC_SLIP)


@struct.dataclass
class BCMaps:
    """Padded per-tag boundary face-node index sets.

    ``idx[tag]`` is a fixed-length int32 array of flat trace indices (into
    `(K*Nfaces*Nfp,)`), padded with 0; ``mask[tag]`` marks valid entries.
    Applying a BC is then a masked scatter (`at[idx].set` guarded by the
    mask) — no per-tag Python loops inside jit.
    """

    idx: dict[int, jnp.ndarray]
    mask: dict[int, jnp.ndarray]

    @staticmethod
    def from_bc_table(bc_face: np.ndarray, nfp: int) -> "BCMaps":
        """bc_face: (K, Nfaces) int tag table; expands to face-node lists."""
        K, Nfaces = bc_face.shape
        # trace layout is (K, Nfaces, Nfp) flattened
        idx = {}
        mask = {}
        for tag in BC_TAGS:
            faces = np.argwhere(bc_face == tag)  # (n, 2) rows (k, f)
            flat = (
                (faces[:, 0] * Nfaces + faces[:, 1])[:, None] * nfp
                + np.arange(nfp)[None, :]
            ).ravel()
            n = flat.size
            size = max(1, n)
            pad_idx = np.zeros((size,), dtype=np.int32)
            pad_idx[:n] = flat
            m = np.zeros((size,), dtype=bool)
            m[:n] = True
            idx[tag] = jnp.asarray(pad_idx)
            mask[tag] = jnp.asarray(m)
        return BCMaps(idx=idx, mask=mask)


@struct.dataclass
class DGContext1D:
    """Frozen 1D discretization (line segments, LGL nodes).

    Reference analog: Nodes1DProvisioner (src/Nodes1DProvisioner.cpp:33-307).
    """

    # static metadata
    n_order: int = struct.field(static=True)
    n_p: int = struct.field(static=True)
    k_elem: int = struct.field(static=True)
    n_faces: int = struct.field(static=True)  # == 2
    n_fp: int = struct.field(static=True)  # == 1

    # reference-element operators (Np, Np) / (Np, Nfaces*Nfp)
    r: jnp.ndarray
    V: jnp.ndarray
    Vinv: jnp.ndarray
    Dr: jnp.ndarray
    lift: jnp.ndarray

    # per-element geometry, element-major (K, Np) / (K, Nfaces*Nfp)
    x: jnp.ndarray
    J: jnp.ndarray
    rx: jnp.ndarray
    nx: jnp.ndarray
    fscale: jnp.ndarray

    # index maps
    vmapM: jnp.ndarray  # (K, Nfaces*Nfp) flat into (K*Np,)
    vmapP: jnp.ndarray
    mapP: jnp.ndarray  # (K, Nfaces*Nfp) flat into (K*Nfaces*Nfp,) trace array
    fmask: jnp.ndarray  # (Nfaces*Nfp,) face-node ids (static gather)
    # inflow/outflow endpoints (flat trace indices / flat volume indices)
    mapI: int = struct.field(static=True)
    mapO: int = struct.field(static=True)
    vmapI: int = struct.field(static=True)
    vmapO: int = struct.field(static=True)

    def surface_trace(self, u: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Interior/exterior traces of (..., K, Np), flattened (see
        DGContext2D.surface_trace for the structured-gather rationale)."""
        fM = jnp.take(u, self.fmask.reshape(-1), axis=-1)
        fM = fM.reshape(*u.shape[:-2], -1)
        fP = jnp.take(fM, self.mapP.reshape(-1), axis=-1)
        return fM, fP


@struct.dataclass
class DGContext2D:
    """Frozen 2D discretization (triangles or quads).

    Reference analog: DGContext2D (include/DGContext2D.hpp:9-259), shapes
    transposed to element-major.
    """

    n_order: int = struct.field(static=True)
    n_p: int = struct.field(static=True)
    k_elem: int = struct.field(static=True)
    n_faces: int = struct.field(static=True)  # 3 tris / 4 quads
    n_fp: int = struct.field(static=True)

    # reference-element operators
    r: jnp.ndarray
    s: jnp.ndarray
    V: jnp.ndarray
    Vinv: jnp.ndarray
    Dr: jnp.ndarray
    Ds: jnp.ndarray
    Drw: jnp.ndarray
    Dsw: jnp.ndarray
    lift: jnp.ndarray  # (Np, Nfaces*Nfp)
    filter: jnp.ndarray  # (Np, Np); identity unless build_filter applied
    fmask: jnp.ndarray  # (Nfaces, Nfp) int32 node ids on each face

    # per-element geometry (K, Np)
    x: jnp.ndarray
    y: jnp.ndarray
    J: jnp.ndarray
    rx: jnp.ndarray
    ry: jnp.ndarray
    sx: jnp.ndarray
    sy: jnp.ndarray

    # per-face-node geometry (K, Nfaces*Nfp)
    nx: jnp.ndarray
    ny: jnp.ndarray
    fscale: jnp.ndarray
    sJ: jnp.ndarray

    # index maps
    vmapM: jnp.ndarray  # (K, Nfaces*Nfp) flat into (K*Np,)
    vmapP: jnp.ndarray
    mapP: jnp.ndarray  # (K, Nfaces*Nfp) flat into (K*Nfaces*Nfp,) traces
    mapB: jnp.ndarray  # padded boundary trace indices
    maskB: jnp.ndarray
    vmapB: jnp.ndarray
    bc_maps: BCMaps
    bc_table: jnp.ndarray  # (K, Nfaces) int32 raw face tag table

    # SEM assembly (gather/scatter over uniquetol'd global nodes)
    gather_ids: jnp.ndarray  # (n_unique,) first occurrence flat node ids
    scatter_ids: jnp.ndarray  # (K*Np,) unique-node id of each nodal point

    # face-granular decomposition of mapP (see face_trace_structure):
    # the '+' trace of face i is face_nbr[i]'s '-' trace, lane-reversed
    # where face_flip[i]. None when mapP has no such structure (then the
    # flat node-level gather below is used). If you replace() mapP, either
    # recompute these with face_trace_structure or set them to None.
    face_nbr: jnp.ndarray | None = None  # (K*Nfaces,) int32
    face_flip: jnp.ndarray | None = None  # (K*Nfaces,) bool

    def surface_trace(self, u: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Interior ('-') and exterior ('+') traces of a (..., K, Np) field,
        flattened over the last two axes.

        Gather-light form: the '-' trace is a STATIC face-node gather
        (fmask indices are compile-time constants). The '+' trace is a
        FACE-granular row gather + lane flip when mapP decomposes that way
        (it always does for conforming meshes: a neighbor's face nodes are
        the same physical points in reversed order), which replaces
        node-level gathers along the minor dimension. Bitwise identical
        to the flat vmapM/vmapP gathers.
        """
        lead = u.shape[:-2]
        fM = jnp.take(u, self.fmask.reshape(-1), axis=-1)
        fM = fM.reshape(*lead, -1)
        if self.face_nbr is None:
            fP = jnp.take(fM, self.mapP.reshape(-1), axis=-1)
            return fM, fP
        n_fp = self.n_fp
        fMf = fM.reshape(*lead, -1, n_fp)  # (..., K*Nfaces, n_fp)
        rows = jnp.take(fMf, self.face_nbr, axis=-2)
        fP = jnp.where(self.face_flip[:, None], rows[..., ::-1], rows)
        return fM, fP.reshape(*lead, -1)

    def grad(self, u: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Nodal gradient of a (K, Np) field via the chain rule (runs under
        the framework matmul-precision scope)."""
        from .config import precision_scope

        with precision_scope():
            ur = u @ self.Dr.T
            us = u @ self.Ds.T
            return self.rx * ur + self.sx * us, self.ry * ur + self.sy * us


def face_trace_structure(mapP, n_fp: int):
    """Decompose a node-level '+'-trace map into face granularity.

    Returns (face_nbr (F,) int32, face_flip (F,) bool) such that
    mapP.reshape(F, n_fp)[i] == face_nbr[i]*n_fp + (n_fp-1 .. 0 if flip
    else 0 .. n_fp-1), or None if any face's map is not a single
    forward/reversed run of one neighbor face (e.g. exotic periodic
    rewrites). Host-side, runs once at context build time.
    """
    rows = np.asarray(mapP).reshape(-1, n_fp)
    face_of = rows // n_fp
    if not (face_of == face_of[:, :1]).all():
        return None
    within = rows % n_fp
    fwd = (within == np.arange(n_fp)).all(axis=1)
    rev = (within == np.arange(n_fp)[::-1]).all(axis=1)
    if n_fp == 1:
        rev = np.zeros_like(fwd)
    if not (fwd | rev).all():
        return None
    return face_of[:, 0].astype(np.int32), rev


def asdict(ctx: Any) -> dict:
    """Shallow dict view of a context (debug/IO convenience)."""
    return {f.name: getattr(ctx, f.name) for f in ctx.__dataclass_fields__.values()}
