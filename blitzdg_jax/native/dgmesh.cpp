// Native mesh-runtime kernels for blitzdg_jax.
//
// The reference's entire runtime is C++ (MeshManager/provisioners); in
// this framework the device compute path is XLA, and the host-side setup hot
// spots live here: face connectivity, interface node matching, and Gmsh
// text parsing. Exposed with a C ABI for ctypes (no pybind11 dependency).
//
// Functional parity targets:
//  - build_connectivity: MeshManager::buildConnectivity
//    (/root/reference/src/MeshManager.cpp:383-489) via hashed face keys
//    instead of the sparse FToV*FToV^T product.
//  - build_maps: TriangleNodesProvisioner::buildMaps
//    (/root/reference/src/TriangleNodesProvisioner.cpp:895-1020) node
//    matching with edge-length-scaled tolerance.
//  - parse_gmsh_elements: the $Elements section scan of
//    MeshManager::readMesh (/root/reference/src/MeshManager.cpp:191-290).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// EToE/EToF from element->vertex connectivity. Arrays are int32,
// etov: (K, nfaces) row-major; outputs same shape. Boundary faces are
// self-referential. Returns 0 on success.
int dg_build_connectivity(const int32_t* etov, int32_t K, int32_t nfaces,
                          int32_t* etoe, int32_t* etof) {
    // key = (min(v1,v2) << 32) | max(v1,v2)
    std::unordered_map<uint64_t, int64_t> first_face;
    first_face.reserve(static_cast<size_t>(K) * nfaces);

    for (int32_t k = 0; k < K; ++k) {
        for (int32_t f = 0; f < nfaces; ++f) {
            etoe[k * nfaces + f] = k;
            etof[k * nfaces + f] = f;
        }
    }

    for (int32_t k = 0; k < K; ++k) {
        for (int32_t f = 0; f < nfaces; ++f) {
            uint64_t v1 = static_cast<uint64_t>(etov[k * nfaces + f]);
            uint64_t v2 = static_cast<uint64_t>(
                etov[k * nfaces + (f + 1) % nfaces]);
            uint64_t key = v1 < v2 ? (v1 << 32) | v2 : (v2 << 32) | v1;
            auto it = first_face.find(key);
            if (it == first_face.end()) {
                first_face.emplace(key, (static_cast<int64_t>(k) << 8) | f);
            } else {
                int64_t packed = it->second;
                int32_t k2 = static_cast<int32_t>(packed >> 8);
                int32_t f2 = static_cast<int32_t>(packed & 0xff);
                etoe[k * nfaces + f] = k2;
                etof[k * nfaces + f] = f2;
                etoe[k2 * nfaces + f2] = k;
                etof[k2 * nfaces + f2] = f;
                first_face.erase(it);
            }
        }
    }
    return 0;
}

// vmapM/vmapP/mapP by physical node matching.
//  x, y: (K*Np) flat row-major volume coordinates
//  fmask: (nfaces, nfp) node ids per face
//  etoe/etof: (K, nfaces)
//  verts: (nv, 2); etov: (K, nfaces) for edge-length tolerance scaling
// Outputs (K, nfaces*nfp) int32 row-major.
int dg_build_maps(const double* x, const double* y, int32_t K, int32_t np_,
                  const int32_t* fmask, int32_t nfaces, int32_t nfp,
                  const int32_t* etoe, const int32_t* etof,
                  const double* verts, const int32_t* etov, double node_tol,
                  int32_t* vmapM, int32_t* vmapP, int32_t* mapP) {
    const int32_t ntr = nfaces * nfp;
    for (int32_t k = 0; k < K; ++k) {
        for (int32_t f = 0; f < nfaces; ++f) {
            // reference edge length for tolerance
            int32_t v1 = etov[k * nfaces + f];
            int32_t v2 = etov[k * nfaces + (f + 1) % nfaces];
            double dx = verts[2 * v1] - verts[2 * v2];
            double dy = verts[2 * v1 + 1] - verts[2 * v2 + 1];
            double refd = std::sqrt(dx * dx + dy * dy);
            double tol = refd * node_tol;

            int32_t k2 = etoe[k * nfaces + f];
            int32_t f2 = etof[k * nfaces + f];

            for (int32_t n = 0; n < nfp; ++n) {
                int32_t vid = k * np_ + fmask[f * nfp + n];
                int32_t tid = k * ntr + f * nfp + n;
                vmapM[tid] = vid;
                vmapP[tid] = vid;  // default: boundary (self)
                mapP[tid] = tid;

                double x1 = x[vid], y1 = y[vid];
                for (int32_t n2 = 0; n2 < nfp; ++n2) {
                    int32_t vid2 = k2 * np_ + fmask[f2 * nfp + n2];
                    double ddx = x1 - x[vid2];
                    double ddy = y1 - y[vid2];
                    if (std::sqrt(ddx * ddx + ddy * ddy) < tol) {
                        vmapP[tid] = vid2;
                        mapP[tid] = k2 * ntr + f2 * nfp + n2;
                        break;
                    }
                }
            }
        }
    }
    return 0;
}

// Minimal Gmsh 2.x $Elements scanner: counts and extracts triangles (type
// 2), quads (type 3) and boundary lines (type 1) with their first physical
// tag. Two-pass ctypes-friendly API: first call with null outputs to get
// counts, then with allocated buffers.
int dg_parse_gmsh_elements(const char* text, int64_t text_len,
                           int32_t* n_tris, int32_t* n_quads, int32_t* n_lines,
                           int32_t* tris /*Kx3*/, int32_t* quads /*Kx4*/,
                           int32_t* lines /*Lx2*/, int32_t* line_tags /*L*/) {
    const char* p = std::strstr(text, "$Elements");
    if (!p) return -1;
    p += 9;
    char* end;
    long n_rows = std::strtol(p, &end, 10);
    p = end;

    int32_t nt = 0, nq = 0, nl = 0;
    for (long i = 0; i < n_rows; ++i) {
        long elm_id = std::strtol(p, &end, 10);
        if (end == p) break;
        p = end;
        (void)elm_id;
        long etype = std::strtol(p, &end, 10);
        p = end;
        long ntags = std::strtol(p, &end, 10);
        p = end;
        long tag0 = 0;
        for (long t = 0; t < ntags; ++t) {
            long tag = std::strtol(p, &end, 10);
            p = end;
            if (t == 0) tag0 = tag;
        }
        int nverts = etype == 1 ? 2 : etype == 2 ? 3 : etype == 3 ? 4
                     : etype == 15 ? 1 : -1;
        if (nverts < 0) {
            // skip rest of line
            while (*p && *p != '\n') ++p;
            continue;
        }
        long v[4] = {0, 0, 0, 0};
        for (int t = 0; t < nverts; ++t) {
            v[t] = std::strtol(p, &end, 10) - 1;  // 1-based -> 0-based
            p = end;
        }
        if (etype == 2) {
            if (tris)
                for (int t = 0; t < 3; ++t) tris[nt * 3 + t] = static_cast<int32_t>(v[t]);
            ++nt;
        } else if (etype == 3) {
            if (quads)
                for (int t = 0; t < 4; ++t) quads[nq * 4 + t] = static_cast<int32_t>(v[t]);
            ++nq;
        } else if (etype == 1) {
            if (lines) {
                lines[nl * 2] = static_cast<int32_t>(v[0]);
                lines[nl * 2 + 1] = static_cast<int32_t>(v[1]);
                line_tags[nl] = static_cast<int32_t>(tag0);
            }
            ++nl;
        }
    }
    *n_tris = nt;
    *n_quads = nq;
    *n_lines = nl;
    return 0;
}

}  // extern "C"
