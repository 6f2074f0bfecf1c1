// Quadric error metric (QEM) edge-collapse mesh decimation.
//
// Native replacement for the pymeshlab
// `meshing_decimation_quadric_edge_collapse` filter the reference pipeline
// uses for mesh simplification (SuGaR coarse-mesh preparation; see
// custom/threestudio-dreammesh4d scripts + sugar mesh extraction).  Classic
// Garland-Heckbert: per-vertex 4x4 plane quadrics, optimal collapse
// placement by solving the 3x3 system, lazy-deletion min-heap, boundary
// constraint quadrics, and a normal-flip rejection test.
//
// Exposed through ctypes (dreammesh4d_tpu_torch/export/decimate.py).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <queue>
#include <vector>
#include <unordered_set>

namespace {

struct Quadric {
  // symmetric 4x4: a2 ab ac ad  b2 bc bd  c2 cd  d2
  double q[10];
  Quadric() { std::memset(q, 0, sizeof(q)); }
  void add_plane(double a, double b, double c, double d, double w) {
    q[0] += w * a * a; q[1] += w * a * b; q[2] += w * a * c; q[3] += w * a * d;
    q[4] += w * b * b; q[5] += w * b * c; q[6] += w * b * d;
    q[7] += w * c * c; q[8] += w * c * d;
    q[9] += w * d * d;
  }
  void add(const Quadric& o) { for (int i = 0; i < 10; ++i) q[i] += o.q[i]; }
  double eval(double x, double y, double z) const {
    return q[0]*x*x + 2*q[1]*x*y + 2*q[2]*x*z + 2*q[3]*x
         + q[4]*y*y + 2*q[5]*y*z + 2*q[6]*y
         + q[7]*z*z + 2*q[8]*z + q[9];
  }
  // Solve for the minimizing point; returns false if near-singular.
  bool optimum(double* out) const {
    double m[9] = {q[0], q[1], q[2], q[1], q[4], q[5], q[2], q[5], q[7]};
    double rhs[3] = {-q[3], -q[6], -q[8]};
    double det = m[0]*(m[4]*m[8]-m[5]*m[7]) - m[1]*(m[3]*m[8]-m[5]*m[6])
               + m[2]*(m[3]*m[7]-m[4]*m[6]);
    double scale = std::fabs(m[0]) + std::fabs(m[4]) + std::fabs(m[8]) + 1e-30;
    if (std::fabs(det) < 1e-10 * scale * scale * scale) return false;
    double inv = 1.0 / det;
    out[0] = inv * (rhs[0]*(m[4]*m[8]-m[5]*m[7]) - m[1]*(rhs[1]*m[8]-m[5]*rhs[2])
                    + m[2]*(rhs[1]*m[7]-m[4]*rhs[2]));
    out[1] = inv * (m[0]*(rhs[1]*m[8]-m[5]*rhs[2]) - rhs[0]*(m[3]*m[8]-m[5]*m[6])
                    + m[2]*(m[3]*rhs[2]-rhs[1]*m[6]));
    out[2] = inv * (m[0]*(m[4]*rhs[2]-rhs[1]*m[7]) - m[1]*(m[3]*rhs[2]-rhs[1]*m[6])
                    + rhs[0]*(m[3]*m[7]-m[4]*m[6]));
    return true;
  }
};

struct HeapEntry {
  double cost;
  int u, v;          // endpoints (canonical reps at push time)
  uint32_t stamp;    // u.version + v.version at push time
  double pos[3];
  bool penalized;
  bool operator<(const HeapEntry& o) const { return cost > o.cost; }  // min-heap
};

struct Ctx {
  int nv, nf;
  std::vector<double> pos;            // 3*nv, updated on collapse
  std::vector<int> f;                 // 3*nf, updated to reps lazily
  std::vector<Quadric> Q;
  std::vector<int> parent;            // union-find
  std::vector<uint32_t> version;
  std::vector<std::vector<int>> vfaces;  // incident (possibly dead) faces
  std::vector<uint8_t> fdead;
  std::priority_queue<HeapEntry> heap;

  int find(int x) {
    while (parent[x] != x) { parent[x] = parent[parent[x]]; x = parent[x]; }
    return x;
  }
};

void face_normal(const double* p0, const double* p1, const double* p2, double* n) {
  double e1[3] = {p1[0]-p0[0], p1[1]-p0[1], p1[2]-p0[2]};
  double e2[3] = {p2[0]-p0[0], p2[1]-p0[1], p2[2]-p0[2]};
  n[0] = e1[1]*e2[2] - e1[2]*e2[1];
  n[1] = e1[2]*e2[0] - e1[0]*e2[2];
  n[2] = e1[0]*e2[1] - e1[1]*e2[0];
}

// cost + optimal position for collapsing edge (u, v); u, v are reps.
void edge_cost(Ctx& c, int u, int v, double* out_pos, double* out_cost) {
  Quadric q = c.Q[u];
  q.add(c.Q[v]);
  double p[3];
  if (!q.optimum(p)) {
    // pick best of endpoints / midpoint
    const double* pu = &c.pos[3*u];
    const double* pv = &c.pos[3*v];
    double mid[3] = {(pu[0]+pv[0])*0.5, (pu[1]+pv[1])*0.5, (pu[2]+pv[2])*0.5};
    double cu = q.eval(pu[0], pu[1], pu[2]);
    double cv = q.eval(pv[0], pv[1], pv[2]);
    double cm = q.eval(mid[0], mid[1], mid[2]);
    if (cu <= cv && cu <= cm) { std::memcpy(p, pu, 24); }
    else if (cv <= cm) { std::memcpy(p, pv, 24); }
    else { std::memcpy(p, mid, 24); }
  }
  std::memcpy(out_pos, p, 24);
  *out_cost = q.eval(p[0], p[1], p[2]);
}

void push_edge(Ctx& c, int u, int v, double penalty) {
  if (u == v) return;
  HeapEntry e;
  e.u = u; e.v = v;
  e.stamp = c.version[u] + c.version[v];
  edge_cost(c, u, v, e.pos, &e.cost);
  e.cost += penalty;
  e.penalized = penalty > 0;
  c.heap.push(e);
}

}  // namespace

extern "C" {

// verts: (nv,3) float32; faces: (nf,3) int32; target_faces: stop when the
// live face count reaches this.  Outputs are malloc'd; caller frees with
// qem_free.  out_map has length nv: original vertex -> output vertex index
// (for host-side attribute carry).  Returns 0 on success.
int qem_decimate(const float* verts, int nv, const int* faces, int nf,
                 int target_faces,
                 float** out_verts, int* out_nv,
                 int** out_faces, int* out_nf,
                 int** out_map) {
  if (nv <= 0 || nf <= 0 || target_faces < 0) return 1;
  Ctx c;
  c.nv = nv; c.nf = nf;
  c.pos.resize(3 * (size_t)nv);
  for (size_t i = 0; i < 3 * (size_t)nv; ++i) c.pos[i] = verts[i];
  c.f.assign(faces, faces + 3 * (size_t)nf);
  c.Q.resize(nv);
  c.parent.resize(nv);
  for (int i = 0; i < nv; ++i) c.parent[i] = i;
  c.version.assign(nv, 0);
  c.vfaces.resize(nv);
  c.fdead.assign(nf, 0);

  // --- plane quadrics (area-weighted) + incidence ---
  for (int fi = 0; fi < nf; ++fi) {
    int a = c.f[3*fi], b = c.f[3*fi+1], d = c.f[3*fi+2];
    if (a < 0 || a >= nv || b < 0 || b >= nv || d < 0 || d >= nv) return 2;
    if (a == b || b == d || a == d) { c.fdead[fi] = 1; continue; }
    double n[3];
    face_normal(&c.pos[3*a], &c.pos[3*b], &c.pos[3*d], n);
    double len = std::sqrt(n[0]*n[0] + n[1]*n[1] + n[2]*n[2]);
    double area = 0.5 * len;
    if (len < 1e-30) { len = 1.0; area = 0.0; }
    n[0] /= len; n[1] /= len; n[2] /= len;
    double off = -(n[0]*c.pos[3*a] + n[1]*c.pos[3*a+1] + n[2]*c.pos[3*a+2]);
    double w = area + 1e-12;
    c.Q[a].add_plane(n[0], n[1], n[2], off, w);
    c.Q[b].add_plane(n[0], n[1], n[2], off, w);
    c.Q[d].add_plane(n[0], n[1], n[2], off, w);
    c.vfaces[a].push_back(fi);
    c.vfaces[b].push_back(fi);
    c.vfaces[d].push_back(fi);
  }

  // --- boundary constraint quadrics: edges with exactly one incident face
  // get a high-weight plane through the edge, perpendicular to the face ---
  {
    struct EKey { int64_t k; int fi; int a; int b; };
    std::vector<EKey> edges;
    edges.reserve(3 * (size_t)nf);
    for (int fi = 0; fi < nf; ++fi) {
      if (c.fdead[fi]) continue;
      for (int e = 0; e < 3; ++e) {
        int a = c.f[3*fi + e], b = c.f[3*fi + (e+1)%3];
        int lo = a < b ? a : b, hi = a < b ? b : a;
        edges.push_back({(int64_t)lo * nv + hi, fi, a, b});
      }
    }
    std::sort(edges.begin(), edges.end(),
              [](const EKey& x, const EKey& y) { return x.k < y.k; });
    for (size_t i = 0; i < edges.size();) {
      size_t j = i;
      while (j < edges.size() && edges[j].k == edges[i].k) ++j;
      if (j - i == 1) {  // boundary edge
        const EKey& ek = edges[i];
        int fi = ek.fi;
        int a = ek.a, b = ek.b;
        int other = c.f[3*fi] + c.f[3*fi+1] + c.f[3*fi+2] - a - b;
        double fn[3];
        face_normal(&c.pos[3*c.f[3*fi]], &c.pos[3*c.f[3*fi+1]], &c.pos[3*c.f[3*fi+2]], fn);
        double ev[3] = {c.pos[3*b]-c.pos[3*a], c.pos[3*b+1]-c.pos[3*a+1], c.pos[3*b+2]-c.pos[3*a+2]};
        // constraint plane normal = edge x face-normal (perpendicular wall)
        double n[3] = {ev[1]*fn[2]-ev[2]*fn[1], ev[2]*fn[0]-ev[0]*fn[2], ev[0]*fn[1]-ev[1]*fn[0]};
        double len = std::sqrt(n[0]*n[0]+n[1]*n[1]+n[2]*n[2]);
        if (len > 1e-30) {
          n[0]/=len; n[1]/=len; n[2]/=len;
          double off = -(n[0]*c.pos[3*a] + n[1]*c.pos[3*a+1] + n[2]*c.pos[3*a+2]);
          double w = 1e3;  // strong boundary preservation
          c.Q[a].add_plane(n[0], n[1], n[2], off, w);
          c.Q[b].add_plane(n[0], n[1], n[2], off, w);
        }
        (void)other;
      }
      i = j;
    }
    // --- seed heap with unique edges ---
    int64_t last = -1;
    for (const EKey& ek : edges) {
      if (ek.k == last) continue;
      last = ek.k;
      push_edge(c, c.find(ek.a), c.find(ek.b), 0.0);
    }
  }

  int live_faces = 0;
  for (int fi = 0; fi < nf; ++fi) if (!c.fdead[fi]) ++live_faces;

  std::vector<int> tmp_faces;
  std::unordered_set<int> nbrs;
  while (live_faces > target_faces && !c.heap.empty()) {
    HeapEntry e = c.heap.top();
    c.heap.pop();
    int u = c.find(e.u), v = c.find(e.v);
    if (u == v) continue;
    if (u != e.u || v != e.v) continue;                    // endpoints merged away
    if (e.stamp != c.version[u] + c.version[v]) continue;  // stale cost

    // --- normal-flip / degeneracy test on surviving faces ---
    bool flip = false;
    tmp_faces.clear();
    for (int pass = 0; pass < 2 && !flip; ++pass) {
      int w = pass == 0 ? u : v;
      for (int fi : c.vfaces[w]) {
        if (c.fdead[fi]) continue;
        int a = c.find(c.f[3*fi]), b = c.find(c.f[3*fi+1]), d = c.find(c.f[3*fi+2]);
        bool has_u = a == u || b == u || d == u;
        bool has_v = a == v || b == v || d == v;
        if (pass == 1 && has_u) continue;  // counted in pass 0
        if (has_u && has_v) continue;      // dies with the collapse
        double p[9];
        const double* src[3] = {&c.pos[3*a], &c.pos[3*b], &c.pos[3*d]};
        int ids[3] = {a, b, d};
        for (int k = 0; k < 3; ++k)
          if (ids[k] == u || ids[k] == v) std::memcpy(&p[3*k], e.pos, 24);
          else std::memcpy(&p[3*k], src[k], 24);
        double n_old[3], n_new[3];
        face_normal(src[0], src[1], src[2], n_old);
        face_normal(&p[0], &p[3], &p[6], n_new);
        double dot = n_old[0]*n_new[0] + n_old[1]*n_new[1] + n_old[2]*n_new[2];
        double nn = std::sqrt(n_new[0]*n_new[0]+n_new[1]*n_new[1]+n_new[2]*n_new[2]);
        double no = std::sqrt(n_old[0]*n_old[0]+n_old[1]*n_old[1]+n_old[2]*n_old[2]);
        if (dot < 1e-12 * no * nn || nn < 1e-14) { flip = true; break; }
      }
    }
    if (flip) {
      if (!e.penalized) push_edge(c, u, v, e.cost + 1e6);  // retry later, once
      continue;
    }

    // --- collapse v into u ---
    c.parent[v] = u;
    c.Q[u].add(c.Q[v]);
    std::memcpy(&c.pos[3*u], e.pos, 24);
    c.version[u]++;

    // merge incidence, retire dead faces, rewrite indices to reps
    for (int fi : c.vfaces[v]) c.vfaces[u].push_back(fi);
    c.vfaces[v].clear();
    c.vfaces[v].shrink_to_fit();
    std::vector<int> keep;
    keep.reserve(c.vfaces[u].size());
    for (int fi : c.vfaces[u]) {
      if (c.fdead[fi]) continue;
      int a = c.find(c.f[3*fi]), b = c.find(c.f[3*fi+1]), d = c.find(c.f[3*fi+2]);
      c.f[3*fi] = a; c.f[3*fi+1] = b; c.f[3*fi+2] = d;
      if (a == b || b == d || a == d) { c.fdead[fi] = 1; --live_faces; continue; }
      keep.push_back(fi);
    }
    // dedupe incidence
    std::sort(keep.begin(), keep.end());
    keep.erase(std::unique(keep.begin(), keep.end()), keep.end());
    c.vfaces[u] = keep;

    // re-evaluate edges around u
    nbrs.clear();
    for (int fi : c.vfaces[u])
      for (int k = 0; k < 3; ++k) {
        int w = c.find(c.f[3*fi + k]);
        if (w != u) nbrs.insert(w);
      }
    for (int w : nbrs) push_edge(c, u, w, 0.0);
  }

  // --- compact output ---
  std::vector<int> new_id(nv, -1);
  int out_count = 0;
  std::vector<int> ofaces;
  ofaces.reserve(3 * (size_t)live_faces);
  for (int fi = 0; fi < nf; ++fi) {
    if (c.fdead[fi]) continue;
    int a = c.find(c.f[3*fi]), b = c.find(c.f[3*fi+1]), d = c.find(c.f[3*fi+2]);
    if (a == b || b == d || a == d) continue;
    int ids[3] = {a, b, d};
    for (int k = 0; k < 3; ++k) {
      if (new_id[ids[k]] < 0) new_id[ids[k]] = out_count++;
      ofaces.push_back(new_id[ids[k]]);
    }
  }
  float* overts = (float*)std::malloc(sizeof(float) * 3 * (size_t)std::max(out_count, 1));
  int* omap = (int*)std::malloc(sizeof(int) * (size_t)nv);
  int* ofp = (int*)std::malloc(sizeof(int) * std::max(ofaces.size(), (size_t)1));
  if (!overts || !omap || !ofp) { std::free(overts); std::free(omap); std::free(ofp); return 3; }
  for (int i = 0; i < nv; ++i) {
    int r = c.find(i);
    omap[i] = new_id[r];  // -1 if the representative emits no face
    if (i == r && new_id[r] >= 0) {
      overts[3*new_id[r]] = (float)c.pos[3*r];
      overts[3*new_id[r]+1] = (float)c.pos[3*r+1];
      overts[3*new_id[r]+2] = (float)c.pos[3*r+2];
    }
  }
  std::memcpy(ofp, ofaces.data(), sizeof(int) * ofaces.size());
  *out_verts = overts;
  *out_nv = out_count;
  *out_faces = ofp;
  *out_nf = (int)(ofaces.size() / 3);
  *out_map = omap;
  return 0;
}

void qem_free(void* p) { std::free(p); }

}  // extern "C"
