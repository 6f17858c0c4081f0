// The port's host octree builder: a plain C interface, loaded with ctypes
// by models/octree.py and compiled at first use by ops/kernels/_build.py
// (build_host) into build/host/.
//
// The reference's acceleration-structure build (Octree.cpp:6-248,
// Mesh.cpp:5-28): 8-way subdivision to depth 6 with the adaptive
// tris-per-vertex stop rule, the exact 13-axis SAT triangle/box test, and
// face-neighbour links for the stackless walk. models/octree.py keeps the
// same algorithm in numpy (generate_octree_plain), and the two agree bit for
// bit: every product here is rounded on its own, as numpy rounds it, so this
// file is compiled with -ffp-contract=off (an FMA-contracted SAT test keeps
// or drops a triangle that grazes a box differently), and `dot` adds left to
// right as numpy's sum over three entries does.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};
inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 mul(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

struct Node {
  V3 bmin, bmax;
  int32_t trisIndex, trisCount;
  int32_t children[8];
  int32_t neighbors[6];
};

struct Builder {
  const float *verts;
  const int32_t *triV;  // (T, 3)
  int32_t nTris;
  std::vector<Node> nodes;
  std::vector<int32_t> pool;
  int maxDepthSeen = 0;

  V3 vert(int32_t i) const { return {verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]}; }
};

// 13-axis SAT triangle/AABB overlap, same axis set and vertex picks as the
// reference (Akenine-Moller optimized form).
bool triBoxOverlap(const Builder &b, int32_t tri, V3 bmin, V3 bmax) {
  V3 center = mul(add(bmin, bmax), 0.5f);
  V3 ext = mul(sub(bmax, bmin), 0.5f);
  V3 a = sub(b.vert(b.triV[3 * tri]), center);
  V3 bb = sub(b.vert(b.triV[3 * tri + 1]), center);
  V3 c = sub(b.vert(b.triV[3 * tri + 2]), center);
  V3 ba = sub(bb, a), cb = sub(c, bb), ac = sub(a, c);

  auto axisFail = [](float p0, float p1, float rad) {
    float lo = std::min(p0, p1), hi = std::max(p0, p1);
    return lo > rad || hi < -rad;
  };

  {
    float ex = std::fabs(ba.x), ey = std::fabs(ba.y), ez = std::fabs(ba.z);
    if (axisFail(ba.z * a.y - ba.y * a.z, ba.z * c.y - ba.y * c.z, ez * ext.y + ey * ext.z)) return false;
    if (axisFail(-ba.z * a.x + ba.x * a.z, -ba.z * c.x + ba.x * c.z, ez * ext.x + ex * ext.z)) return false;
    if (axisFail(ba.y * bb.x - ba.x * bb.y, ba.y * c.x - ba.x * c.y, ey * ext.x + ex * ext.y)) return false;
  }
  {
    float ex = std::fabs(cb.x), ey = std::fabs(cb.y), ez = std::fabs(cb.z);
    if (axisFail(cb.z * a.y - cb.y * a.z, cb.z * c.y - cb.y * c.z, ez * ext.y + ey * ext.z)) return false;
    if (axisFail(-cb.z * a.x + cb.x * a.z, -cb.z * c.x + cb.x * c.z, ez * ext.x + ex * ext.z)) return false;
    if (axisFail(cb.y * a.x - cb.x * a.y, cb.y * bb.x - cb.x * bb.y, ey * ext.x + ex * ext.y)) return false;
  }
  {
    float ex = std::fabs(ac.x), ey = std::fabs(ac.y), ez = std::fabs(ac.z);
    if (axisFail(ac.z * a.y - ac.y * a.z, ac.z * bb.y - ac.y * bb.z, ez * ext.y + ey * ext.z)) return false;
    if (axisFail(-ac.z * a.x + ac.x * a.z, -ac.z * bb.x + ac.x * bb.z, ez * ext.x + ex * ext.z)) return false;
    if (axisFail(ac.y * bb.x - ac.x * bb.y, ac.y * c.x - ac.x * c.y, ey * ext.x + ex * ext.y)) return false;
  }
  {
    V3 n = cross(ba, cb);
    V3 vmin, vmax;
    vmin.x = n.x > 0 ? -ext.x - a.x : ext.x - a.x;
    vmax.x = n.x > 0 ? ext.x - a.x : -ext.x - a.x;
    vmin.y = n.y > 0 ? -ext.y - a.y : ext.y - a.y;
    vmax.y = n.y > 0 ? ext.y - a.y : -ext.y - a.y;
    vmin.z = n.z > 0 ? -ext.z - a.z : ext.z - a.z;
    vmax.z = n.z > 0 ? ext.z - a.z : -ext.z - a.z;
    if (dot(n, vmin) > 0) return false;
    if (dot(n, vmax) < 0) return false;
  }
  {
    V3 lo{std::min({a.x, bb.x, c.x}), std::min({a.y, bb.y, c.y}), std::min({a.z, bb.z, c.z})};
    V3 hi{std::max({a.x, bb.x, c.x}), std::max({a.y, bb.y, c.y}), std::max({a.z, bb.z, c.z})};
    if (lo.x > ext.x || hi.x < -ext.x) return false;
    if (lo.y > ext.y || hi.y < -ext.y) return false;
    if (lo.z > ext.z || hi.z < -ext.z) return false;
  }
  return true;
}

void subdivide(Builder &b, int32_t node, int32_t minTris, int depth, int curDepth) {
  b.maxDepthSeen = std::max(b.maxDepthSeen, curDepth);
  int32_t count = b.nodes[node].trisCount;
  if (depth <= 0 || count <= minTris) return;
  int32_t start = b.nodes[node].trisIndex;

  // Adaptive stop rule: next level's threshold is this node's max
  // triangles-per-vertex (matches the reference builder).
  std::unordered_map<int32_t, int32_t> perVert;
  int32_t maxPerVert = 0;
  for (int32_t k = start; k < start + count; ++k) {
    int32_t t = b.pool[k];
    for (int j = 0; j < 3; ++j) {
      int32_t c = ++perVert[b.triV[3 * t + j]];
      maxPerVert = std::max(maxPerVert, c);
    }
  }

  V3 nmin = b.nodes[node].bmin;
  V3 half = mul(sub(b.nodes[node].bmax, nmin), 0.5f);

  int32_t children[8];
  for (int x = 0; x < 2; ++x)
    for (int y = 0; y < 2; ++y)
      for (int z = 0; z < 2; ++z) {
        Node child{};
        child.bmin = {nmin.x + half.x * x, nmin.y + half.y * y, nmin.z + half.z * z};
        child.bmax = add(child.bmin, half);
        child.trisIndex = int32_t(b.pool.size());
        child.trisCount = 0;
        std::fill(child.children, child.children + 8, -1);
        std::fill(child.neighbors, child.neighbors + 6, -1);
        int32_t ci = int32_t(b.nodes.size());
        children[z + 2 * y + 4 * x] = ci;
        b.nodes.push_back(child);
        for (int32_t k = start; k < start + count; ++k) {
          int32_t t = b.pool[k];
          if (triBoxOverlap(b, t, b.nodes[ci].bmin, b.nodes[ci].bmax)) {
            b.pool.push_back(t);
            b.nodes[ci].trisCount++;
          }
        }
      }
  std::copy(children, children + 8, b.nodes[node].children);

  const int32_t *pn = b.nodes[node].neighbors;
  for (int x = 0; x < 2; ++x)
    for (int y = 0; y < 2; ++y)
      for (int z = 0; z < 2; ++z) {
        int ci = 4 * x + 2 * y + z;
        int32_t *cn = b.nodes[children[ci]].neighbors;
        cn[0] = z == 0 ? pn[0] : children[ci - 1];
        cn[1] = z == 0 ? children[ci + 1] : pn[1];
        cn[2] = x == 0 ? pn[2] : children[ci - 4];
        cn[3] = x == 0 ? children[ci + 4] : pn[3];
        cn[4] = y == 0 ? pn[4] : children[ci - 2];
        cn[5] = y == 0 ? children[ci + 2] : pn[5];
      }

  for (int i = 0; i < 8; ++i)
    subdivide(b, children[i], maxPerVert, depth - 1, curDepth + 1);
}

}  // namespace

extern "C" {

// Build an octree over triangles [0, n_tris) seeded into a root with the
// given bounds. Returns an opaque handle (or null on failure).
void *rpt_octree_build(const float *verts, int32_t n_verts,
                       const int32_t *tri_v, int32_t n_tris,
                       const float bmin[3], const float bmax[3],
                       int32_t max_depth) {
  (void)n_verts;
  auto *b = new (std::nothrow) Builder();
  if (!b) return nullptr;
  b->verts = verts;
  b->triV = tri_v;
  b->nTris = n_tris;

  Node root{};
  root.bmin = {bmin[0], bmin[1], bmin[2]};
  root.bmax = {bmax[0], bmax[1], bmax[2]};
  root.trisIndex = 0;
  root.trisCount = n_tris;
  std::fill(root.children, root.children + 8, -1);
  std::fill(root.neighbors, root.neighbors + 6, -1);
  b->nodes.push_back(root);
  b->pool.resize(n_tris);
  for (int32_t i = 0; i < n_tris; ++i) b->pool[i] = i;

  subdivide(*b, 0, 0, max_depth, 0);
  return b;
}

int32_t rpt_octree_num_nodes(void *h) { return int32_t(static_cast<Builder *>(h)->nodes.size()); }
int32_t rpt_octree_pool_size(void *h) { return int32_t(static_cast<Builder *>(h)->pool.size()); }
int32_t rpt_octree_max_depth(void *h) { return static_cast<Builder *>(h)->maxDepthSeen; }

// Copy out SoA arrays; caller allocates.
void rpt_octree_export(void *h, float *node_min, float *node_max,
                       int32_t *tris_index, int32_t *tris_count,
                       int32_t *children, int32_t *neighbors, int32_t *pool) {
  Builder *b = static_cast<Builder *>(h);
  for (size_t i = 0; i < b->nodes.size(); ++i) {
    const Node &n = b->nodes[i];
    std::memcpy(node_min + 3 * i, &n.bmin, 12);
    std::memcpy(node_max + 3 * i, &n.bmax, 12);
    tris_index[i] = n.trisIndex;
    tris_count[i] = n.trisCount;
    std::memcpy(children + 8 * i, n.children, 32);
    std::memcpy(neighbors + 6 * i, n.neighbors, 24);
  }
  std::memcpy(pool, b->pool.data(), b->pool.size() * 4);
}

void rpt_octree_free(void *h) { delete static_cast<Builder *>(h); }

}  // extern "C"
