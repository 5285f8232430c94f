// Native track-graph builder: union-find over match endpoints.
//
// The port's copy of native/trackbuilder.cpp, built with g++ into build/
// by detectorfreesfm_tpu_torch/sfm/tracks.py.
//
// The host-side hot loop of track construction (sfm/tracks.py) is a
// serial union-find over every verified match edge — pure Python costs
// ~1us/edge which dominates scene setup at IMC scale (10k+ pairs x 2k
// matches). This C++ path does the same joins at ~10ns/edge and
// returns the root array; component grouping stays in numpy.
//
// Exposed C ABI (ctypes):
//   void uf_build(int64_t n_nodes, const int64_t* edges_a,
//                 const int64_t* edges_b, int64_t n_edges, int64_t* roots);
//
// Semantics match the Python fallback exactly: smallest-id root wins every
// union, full path compression, deterministic for any edge order.

#include <cstdint>
#include <vector>

extern "C" {

static int64_t find(std::vector<int64_t>& parent, int64_t i) {
    int64_t root = i;
    while (parent[root] != root) root = parent[root];
    while (parent[i] != root) {
        int64_t next = parent[i];
        parent[i] = root;
        i = next;
    }
    return root;
}

void uf_build(int64_t n_nodes, const int64_t* edges_a, const int64_t* edges_b,
              int64_t n_edges, int64_t* roots) {
    std::vector<int64_t> parent(n_nodes);
    for (int64_t i = 0; i < n_nodes; ++i) parent[i] = i;
    for (int64_t e = 0; e < n_edges; ++e) {
        int64_t ra = find(parent, edges_a[e]);
        int64_t rb = find(parent, edges_b[e]);
        if (ra != rb) {
            int64_t r = ra < rb ? ra : rb;
            parent[ra] = r;
            parent[rb] = r;
        }
    }
    for (int64_t i = 0; i < n_nodes; ++i) roots[i] = find(parent, i);
}

}  // extern "C"
