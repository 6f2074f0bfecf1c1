// Isosurface extraction via marching tetrahedra (6-tet cube decomposition).
//
// Native replacement for the PyMCubes dependency used by the reference's
// `mc-cpu` export path (threestudio/models/isosurface.py:19-67 and
// custom/.../geometry/gaussian_io.py:267-291): given a dense scalar grid,
// extract the iso-surface triangle mesh on the host.  Marching tetrahedra is
// table-free (cases derived from sign patterns), watertight, and produces
// meshes that interoperate with the downstream simplifier / SuGaR binding
// exactly like the reference MC output.
//
// C ABI (consumed through ctypes from dreammesh4d_tpu_torch/export/isosurface.py):
//   mt_extract(grid, nx, ny, nz, iso, &verts, &nv, &faces, &nf) -> 0 on ok
//   mt_free(ptr)
// Vertices are deduplicated per grid edge via a hash map, so shared edges
// yield shared vertices (watertight connectivity).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

// The 6-tetrahedron decomposition of a cube along the main diagonal 0-7:
// one tet per monotone corner path 0 -> axis -> face -> 7.  All cubes share
// the same diagonal orientation, so face diagonals match between neighbors
// (watertight tiling).  Cube corner numbering: bit0=x, bit1=y, bit2=z.
static const int kTets[6][4] = {
    {0, 1, 3, 7}, {0, 1, 5, 7}, {0, 2, 3, 7},
    {0, 2, 6, 7}, {0, 4, 5, 7}, {0, 4, 6, 7},
};

inline int64_t edge_key(int64_t a, int64_t b) {
  if (a > b) std::swap(a, b);
  return (a << 32) | b;
}

struct Extractor {
  const float* grid;
  int nx, ny, nz;
  float iso;
  std::vector<float> verts;
  std::vector<int> faces;
  std::unordered_map<int64_t, int> edge_to_vert;

  inline int64_t lin(int x, int y, int z) const {
    return (static_cast<int64_t>(x) * ny + y) * nz + z;
  }
  inline float val(int64_t idx) const { return grid[idx]; }
  inline V3 pos(int64_t idx) const {
    int z = static_cast<int>(idx % nz);
    int y = static_cast<int>((idx / nz) % ny);
    int x = static_cast<int>(idx / (static_cast<int64_t>(ny) * nz));
    return {static_cast<float>(x), static_cast<float>(y), static_cast<float>(z)};
  }

  int edge_vertex(int64_t a, int64_t b) {
    int64_t key = edge_key(a, b);
    auto it = edge_to_vert.find(key);
    if (it != edge_to_vert.end()) return it->second;
    float va = val(a), vb = val(b);
    float t = (iso - va) / (vb - va);
    if (t < 0.f) t = 0.f;
    if (t > 1.f) t = 1.f;
    V3 pa = pos(a), pb = pos(b);
    int id = static_cast<int>(verts.size() / 3);
    verts.push_back(pa.x + t * (pb.x - pa.x));
    verts.push_back(pa.y + t * (pb.y - pa.y));
    verts.push_back(pa.z + t * (pb.z - pa.z));
    edge_to_vert.emplace(key, id);
    return id;
  }

  // trilinear field gradient at a point (grid units, clamped central diff)
  V3 gradient_at(float px, float py, float pz) const {
    int x = static_cast<int>(px), y = static_cast<int>(py), z = static_cast<int>(pz);
    auto clampi = [](int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); };
    x = clampi(x, 1, nx - 2);
    y = clampi(y, 1, ny - 2);
    z = clampi(z, 1, nz - 2);
    float gx = val(lin(x + 1, y, z)) - val(lin(x - 1, y, z));
    float gy = val(lin(x, y + 1, z)) - val(lin(x, y - 1, z));
    float gz = val(lin(x, y, z + 1)) - val(lin(x, y, z - 1));
    return {gx, gy, gz};
  }

  // Emit with outward orientation: the triangle normal should point toward
  // DECREASING field (out of the density > iso region).
  void emit(int v0, int v1, int v2) {
    const float* a = &verts[3 * v0];
    const float* b = &verts[3 * v1];
    const float* c = &verts[3 * v2];
    float e1[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
    float e2[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
    float n[3] = {e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2],
                  e1[0] * e2[1] - e1[1] * e2[0]};
    float cx = (a[0] + b[0] + c[0]) / 3.f;
    float cy = (a[1] + b[1] + c[1]) / 3.f;
    float cz = (a[2] + b[2] + c[2]) / 3.f;
    V3 g = gradient_at(cx, cy, cz);
    float d = n[0] * g.x + n[1] * g.y + n[2] * g.z;
    if (d > 0) {  // pointing toward increasing field -> flip
      int tmp = v1;
      v1 = v2;
      v2 = tmp;
    }
    faces.push_back(v0);
    faces.push_back(v1);
    faces.push_back(v2);
  }

  // Process one tetrahedron given its 4 global grid indices.
  void do_tet(int64_t i0, int64_t i1, int64_t i2, int64_t i3) {
    const int64_t idx[4] = {i0, i1, i2, i3};
    int mask = 0;
    for (int k = 0; k < 4; ++k)
      if (val(idx[k]) > iso) mask |= (1 << k);
    if (mask == 0 || mask == 15) return;

    // collect inside (above iso) and outside corner slots
    int in[4], out[4], ni = 0, no = 0;
    for (int k = 0; k < 4; ++k) {
      if (mask & (1 << k))
        in[ni++] = k;
      else
        out[no++] = k;
    }

    if (ni == 1) {
      int a = edge_vertex(idx[in[0]], idx[out[0]]);
      int b = edge_vertex(idx[in[0]], idx[out[1]]);
      int c = edge_vertex(idx[in[0]], idx[out[2]]);
      emit(a, b, c);
    } else if (ni == 3) {
      int a = edge_vertex(idx[out[0]], idx[in[0]]);
      int b = edge_vertex(idx[out[0]], idx[in[1]]);
      int c = edge_vertex(idx[out[0]], idx[in[2]]);
      emit(a, b, c);
    } else {  // ni == 2: quad -> two triangles
      int a = edge_vertex(idx[in[0]], idx[out[0]]);
      int b = edge_vertex(idx[in[0]], idx[out[1]]);
      int c = edge_vertex(idx[in[1]], idx[out[1]]);
      int d = edge_vertex(idx[in[1]], idx[out[0]]);
      emit(a, b, c);
      emit(a, c, d);
    }
  }

  void run() {
    for (int x = 0; x < nx - 1; ++x) {
      for (int y = 0; y < ny - 1; ++y) {
        for (int z = 0; z < nz - 1; ++z) {
          int64_t corner[8];
          for (int c = 0; c < 8; ++c) {
            int cx = x + (c & 1);
            int cy = y + ((c >> 1) & 1);
            int cz = z + ((c >> 2) & 1);
            corner[c] = lin(cx, cy, cz);
          }
          // quick reject
          bool any_in = false, any_out = false;
          for (int c = 0; c < 8; ++c) {
            if (val(corner[c]) > iso)
              any_in = true;
            else
              any_out = true;
          }
          if (!any_in || !any_out) continue;
          for (int t = 0; t < 6; ++t)
            do_tet(corner[kTets[t][0]], corner[kTets[t][1]],
                   corner[kTets[t][2]], corner[kTets[t][3]]);
        }
      }
    }
  }
};

}  // namespace

extern "C" {

int mt_extract(const float* grid, int nx, int ny, int nz, float iso,
               float** out_verts, int* out_nv, int** out_faces, int* out_nf) {
  if (!grid || nx < 2 || ny < 2 || nz < 2) return 1;
  Extractor ex;
  ex.grid = grid;
  ex.nx = nx;
  ex.ny = ny;
  ex.nz = nz;
  ex.iso = iso;
  ex.run();
  *out_nv = static_cast<int>(ex.verts.size() / 3);
  *out_nf = static_cast<int>(ex.faces.size() / 3);
  *out_verts = static_cast<float*>(std::malloc(ex.verts.size() * sizeof(float)));
  *out_faces = static_cast<int*>(std::malloc(ex.faces.size() * sizeof(int)));
  std::memcpy(*out_verts, ex.verts.data(), ex.verts.size() * sizeof(float));
  std::memcpy(*out_faces, ex.faces.data(), ex.faces.size() * sizeof(int));
  return 0;
}

void mt_free(void* p) { std::free(p); }

}  // extern "C"
