// Host graph engine of rmm_tpu_torch: the port's own copy of
// rmm_tpu/graph/csrc/graph_engine.cpp (same sampling, same random stream),
// so the port never imports rmm_tpu. Host-side C++ primitives feeding
// static-shape device buffers.
//
// Only what the port's paths read: the CSR graph, its in-degrees,
// edge-seeded k-hop sampling (pyg-lib's NeighborSampler contract: seed edges
// first, PADDED fixed-capacity neighborhoods, local relabeling in the same
// pass), node-seeded k-hop sampling (node classification: seed nodes first),
// negative sampling for link prediction and port numbering.
//
// Exposed through a plain C ABI consumed via ctypes (no pybind11 in image).

#include <algorithm>
#include <cstdint>
#include <random>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Csr {
  std::vector<int64_t> offsets;   // size num_nodes + 1
  std::vector<int64_t> nbr;       // neighbor node id per incident edge
  std::vector<int64_t> eid;       // global edge id per incident edge
};

struct Graph {
  int64_t num_nodes = 0;
  std::vector<int64_t> src, dst, eids;
  Csr in_csr;    // indexed by dst: incoming edges (u -> v stored at v)
  Csr out_csr;   // indexed by src: outgoing edges
};

Csr build_csr(const std::vector<int64_t>& key, const std::vector<int64_t>& other,
              const std::vector<int64_t>& eids, int64_t num_nodes) {
  Csr csr;
  const int64_t m = static_cast<int64_t>(key.size());
  csr.offsets.assign(num_nodes + 1, 0);
  for (int64_t i = 0; i < m; ++i) csr.offsets[key[i] + 1]++;
  for (int64_t v = 0; v < num_nodes; ++v) csr.offsets[v + 1] += csr.offsets[v];
  csr.nbr.resize(m);
  csr.eid.resize(m);
  std::vector<int64_t> cur(csr.offsets.begin(), csr.offsets.end() - 1);
  for (int64_t i = 0; i < m; ++i) {
    int64_t pos = cur[key[i]]++;
    csr.nbr[pos] = other[i];
    csr.eid[pos] = eids[i];
  }
  return csr;
}

// Sample up to `fanout` incident slots of node v from `csr` without
// replacement (partial Fisher-Yates over the slot range).
template <typename Visit>
void sample_incident(const Csr& csr, int64_t v, int64_t fanout,
                     std::mt19937_64& rng, std::vector<int64_t>& scratch,
                     Visit&& visit) {
  int64_t beg = csr.offsets[v], end = csr.offsets[v + 1];
  int64_t deg = end - beg;
  if (deg <= 0) return;
  if (fanout < 0 || deg <= fanout) {
    for (int64_t p = beg; p < end; ++p) visit(csr.nbr[p], csr.eid[p]);
    return;
  }
  scratch.resize(deg);
  for (int64_t i = 0; i < deg; ++i) scratch[i] = beg + i;
  for (int64_t i = 0; i < fanout; ++i) {
    std::uniform_int_distribution<int64_t> dis(i, deg - 1);
    std::swap(scratch[i], scratch[dis(rng)]);
    int64_t p = scratch[i];
    visit(csr.nbr[p], csr.eid[p]);
  }
}

struct SampleOut {
  std::vector<int64_t> edge_ids, esrc, edst;  // global ids, seed edges first
};

// k-hop expansion from a node frontier, sampling incoming edges per hop
// (GraphSAGE-style message-flow direction, matching pyg NeighborSampler).
// `seen_edges` is pre-seeded with seed edge ids so they are not re-added.
void khop_expand(const Graph& g, std::vector<int64_t> frontier,
                 const int64_t* fanouts, int n_hops, std::mt19937_64& rng,
                 std::unordered_set<int64_t>& seen_edges, SampleOut& out,
                 bool undirected) {
  std::vector<int64_t> scratch;
  std::unordered_set<int64_t> frontier_seen(frontier.begin(), frontier.end());
  for (int h = 0; h < n_hops; ++h) {
    std::vector<int64_t> next;
    int64_t fanout = fanouts[h];
    for (int64_t v : frontier) {
      auto visit_in = [&](int64_t u, int64_t e) {
        if (seen_edges.insert(e).second) {
          out.edge_ids.push_back(e);
          out.esrc.push_back(u);     // incoming edge u -> v
          out.edst.push_back(v);
        }
        if (frontier_seen.insert(u).second) next.push_back(u);
      };
      sample_incident(g.in_csr, v, fanout, rng, scratch, visit_in);
      if (undirected) {
        auto visit_out = [&](int64_t u, int64_t e) {
          if (seen_edges.insert(e).second) {
            out.edge_ids.push_back(e);
            out.esrc.push_back(v);   // outgoing edge v -> u
            out.edst.push_back(u);
          }
          if (frontier_seen.insert(u).second) next.push_back(u);
        };
        sample_incident(g.out_csr, v, fanout, rng, scratch, visit_out);
      }
    }
    frontier = std::move(next);
  }
}

}  // namespace

extern "C" {

void* rmm_graph_create(const int64_t* src, const int64_t* dst,
                       const int64_t* eids, int64_t num_edges,
                       int64_t num_nodes) {
  auto* g = new Graph();
  g->num_nodes = num_nodes;
  g->src.assign(src, src + num_edges);
  g->dst.assign(dst, dst + num_edges);
  g->eids.assign(eids, eids + num_edges);
  g->in_csr = build_csr(g->dst, g->src, g->eids, num_nodes);
  g->out_csr = build_csr(g->src, g->dst, g->eids, num_nodes);
  return g;
}

void rmm_graph_destroy(void* handle) { delete static_cast<Graph*>(handle); }

void rmm_in_degrees(void* handle, int64_t* out) {
  auto* g = static_cast<Graph*>(handle);
  for (int64_t v = 0; v < g->num_nodes; ++v)
    out[v] = g->in_csr.offsets[v + 1] - g->in_csr.offsets[v];
}

// Edge-seeded k-hop sampling. Outputs (all padded to capacity, pad = -1):
//   out_edge_ids[max_edges]     global edge row ids, SEED EDGES FIRST in
//                               input order (contract of reference
//                               sample_neighbors, ibm_...py:63-66)
//   out_src_local / out_dst_local[max_edges]   local node ids
//   out_node_ids[max_nodes]     sorted-unique global node ids (reference
//                               relabel uses torch.unique order)
//   out_counts[3] = {n_edges, n_nodes, n_dropped_edges}
// Returns 0 on success, -1 if node capacity was exceeded (nodes of dropped
// edges never enter the set; seeds always fit or -1).
int64_t rmm_sample_from_edges(void* handle, const int64_t* seed_src,
                              const int64_t* seed_dst, const int64_t* seed_ids,
                              int64_t n_seeds, const int64_t* fanouts,
                              int32_t n_hops, uint64_t rng_seed,
                              int32_t undirected, int64_t max_edges,
                              int64_t max_nodes, int64_t* out_edge_ids,
                              int64_t* out_src_local, int64_t* out_dst_local,
                              int64_t* out_node_ids, int64_t* out_counts) {
  auto* g = static_cast<Graph*>(handle);
  std::mt19937_64 rng(rng_seed);

  SampleOut out;
  out.edge_ids.reserve(max_edges);
  std::unordered_set<int64_t> seen_edges;
  std::vector<int64_t> frontier;
  frontier.reserve(2 * n_seeds);
  std::unordered_set<int64_t> fseen;
  for (int64_t i = 0; i < n_seeds; ++i) {
    out.edge_ids.push_back(seed_ids[i]);
    out.esrc.push_back(seed_src[i]);
    out.edst.push_back(seed_dst[i]);
    seen_edges.insert(seed_ids[i]);
    if (fseen.insert(seed_src[i]).second) frontier.push_back(seed_src[i]);
    if (fseen.insert(seed_dst[i]).second) frontier.push_back(seed_dst[i]);
  }
  khop_expand(*g, std::move(frontier), fanouts, n_hops, rng, seen_edges, out,
              undirected != 0);

  int64_t total = static_cast<int64_t>(out.edge_ids.size());
  int64_t kept = std::min<int64_t>(total, max_edges);
  int64_t dropped = total - kept;

  // node set: sorted unique over kept edges
  std::vector<int64_t> nodes;
  nodes.reserve(2 * kept);
  for (int64_t i = 0; i < kept; ++i) {
    nodes.push_back(out.esrc[i]);
    nodes.push_back(out.edst[i]);
  }
  std::sort(nodes.begin(), nodes.end());
  nodes.erase(std::unique(nodes.begin(), nodes.end()), nodes.end());
  if (static_cast<int64_t>(nodes.size()) > max_nodes) return -1;

  std::unordered_map<int64_t, int64_t> local;
  local.reserve(nodes.size() * 2);
  for (size_t i = 0; i < nodes.size(); ++i) local[nodes[i]] = i;

  for (int64_t i = 0; i < kept; ++i) {
    out_edge_ids[i] = out.edge_ids[i];
    out_src_local[i] = local[out.esrc[i]];
    out_dst_local[i] = local[out.edst[i]];
  }
  for (int64_t i = kept; i < max_edges; ++i) {
    out_edge_ids[i] = -1;
    out_src_local[i] = 0;
    out_dst_local[i] = 0;
  }
  for (size_t i = 0; i < nodes.size(); ++i) out_node_ids[i] = nodes[i];
  for (int64_t i = nodes.size(); i < max_nodes; ++i) out_node_ids[i] = -1;
  out_counts[0] = kept;
  out_counts[1] = static_cast<int64_t>(nodes.size());
  out_counts[2] = dropped;
  return 0;
}

// Node-seeded k-hop sampling. Node order = SEED NODES FIRST (input order,
// a repeated seed once), then the remaining sampled nodes sorted (reference
// node_inputs, src/utils/batch_processing.py:40-47). Outputs and return
// code as rmm_sample_from_edges'; the sampled edges are the hops' alone.
int64_t rmm_sample_from_nodes(void* handle, const int64_t* seed_nodes,
                              int64_t n_seeds, const int64_t* fanouts,
                              int32_t n_hops, uint64_t rng_seed,
                              int32_t undirected, int64_t max_edges,
                              int64_t max_nodes, int64_t* out_edge_ids,
                              int64_t* out_src_local, int64_t* out_dst_local,
                              int64_t* out_node_ids, int64_t* out_counts) {
  auto* g = static_cast<Graph*>(handle);
  std::mt19937_64 rng(rng_seed);

  SampleOut out;
  std::unordered_set<int64_t> seen_edges;
  std::vector<int64_t> frontier(seed_nodes, seed_nodes + n_seeds);
  khop_expand(*g, frontier, fanouts, n_hops, rng, seen_edges, out,
              undirected != 0);

  int64_t total = static_cast<int64_t>(out.edge_ids.size());
  int64_t kept = std::min<int64_t>(total, max_edges);
  int64_t dropped = total - kept;

  std::unordered_map<int64_t, int64_t> local;
  local.reserve(max_nodes * 2);
  std::vector<int64_t> nodes;
  for (int64_t i = 0; i < n_seeds; ++i) {
    if (local.emplace(seed_nodes[i], nodes.size()).second)
      nodes.push_back(seed_nodes[i]);
  }
  std::vector<int64_t> rest;
  rest.reserve(2 * kept);
  for (int64_t i = 0; i < kept; ++i) {
    rest.push_back(out.esrc[i]);
    rest.push_back(out.edst[i]);
  }
  std::sort(rest.begin(), rest.end());
  rest.erase(std::unique(rest.begin(), rest.end()), rest.end());
  for (int64_t v : rest) {
    if (local.emplace(v, nodes.size()).second) nodes.push_back(v);
  }
  if (static_cast<int64_t>(nodes.size()) > max_nodes) return -1;

  for (int64_t i = 0; i < kept; ++i) {
    out_edge_ids[i] = out.edge_ids[i];
    out_src_local[i] = local[out.esrc[i]];
    out_dst_local[i] = local[out.edst[i]];
  }
  for (int64_t i = kept; i < max_edges; ++i) {
    out_edge_ids[i] = -1;
    out_src_local[i] = 0;
    out_dst_local[i] = 0;
  }
  for (size_t i = 0; i < nodes.size(); ++i) out_node_ids[i] = nodes[i];
  for (int64_t i = nodes.size(); i < max_nodes; ++i) out_node_ids[i] = -1;
  out_counts[0] = kept;
  out_counts[1] = static_cast<int64_t>(nodes.size());
  out_counts[2] = dropped;
  return 0;
}

// Negative sampling over a LOCAL subgraph: for each positive edge, emit
// num_neg/2 (src, corrupt) pairs then num_neg - num_neg/2 (corrupt, dst)
// pairs, where `corrupt` avoids both endpoints and their full (undirected)
// adjacency within the subgraph. Deterministic: seeded rejection sampling
// with a linear-probe fallback after 64 misses.
void rmm_negative_sample(const int64_t* src, const int64_t* dst,
                         int64_t n_edges, const int64_t* pos_src,
                         const int64_t* pos_dst, int64_t n_pos,
                         int64_t num_nodes, int64_t num_neg, uint64_t seed,
                         int64_t* out_src, int64_t* out_dst) {
  std::unordered_map<int64_t, std::unordered_set<int64_t>> adj;
  adj.reserve(num_nodes * 2);
  for (int64_t i = 0; i < n_edges; ++i) {
    adj[src[i]].insert(dst[i]);
    adj[dst[i]].insert(src[i]);
  }
  std::mt19937_64 rng(seed);
  std::uniform_int_distribution<int64_t> dis(0, num_nodes - 1);

  int64_t w = 0;
  for (int64_t i = 0; i < n_pos; ++i) {
    int64_t s = pos_src[i], d = pos_dst[i];
    auto banned = [&](int64_t v) {
      if (v == s || v == d) return true;
      auto it = adj.find(s);
      if (it != adj.end() && it->second.count(v)) return true;
      it = adj.find(d);
      if (it != adj.end() && it->second.count(v)) return true;
      return false;
    };
    auto draw = [&]() {
      for (int t = 0; t < 64; ++t) {
        int64_t v = dis(rng);
        if (!banned(v)) return v;
      }
      int64_t start = dis(rng);
      for (int64_t k = 0; k < num_nodes; ++k) {
        int64_t v = (start + k) % num_nodes;
        if (!banned(v)) return v;
      }
      return (s + 1) % num_nodes;  // fully-connected fallback
    };
    for (int64_t j = 0; j < num_neg / 2; ++j) {
      out_src[w] = s;
      out_dst[w] = draw();
      ++w;
    }
    for (int64_t j = 0; j < num_neg - num_neg / 2; ++j) {
      out_src[w] = draw();
      out_dst[w] = d;
      ++w;
    }
  }
}

// Port numbering: for each directed edge (u -> v), in_port = rank of u among
// v's time-sorted unique in-neighbors; out_port analogously on the reversed
// graph (reference src/datasets/util/graph.py:81-102).
void rmm_ports(const int64_t* src, const int64_t* dst, const int64_t* ts,
               int64_t n_edges, int64_t num_nodes, double* in_ports,
               double* out_ports) {
  struct Inc {
    int64_t nbr, t, eid;
  };
  auto compute = [&](const int64_t* key, const int64_t* other, double* out) {
    std::vector<std::vector<Inc>> by_node(num_nodes);
    for (int64_t i = 0; i < n_edges; ++i)
      by_node[key[i]].push_back({other[i], ts ? ts[i] : 0, i});
    std::unordered_map<int64_t, int64_t> rank;
    for (int64_t v = 0; v < num_nodes; ++v) {
      auto& inc = by_node[v];
      if (inc.empty()) continue;
      std::stable_sort(inc.begin(), inc.end(),
                       [](const Inc& a, const Inc& b) { return a.t < b.t; });
      rank.clear();
      int64_t next = 0;
      for (auto& e : inc) {
        auto it = rank.find(e.nbr);
        if (it == rank.end()) it = rank.emplace(e.nbr, next++).first;
        out[e.eid] = static_cast<double>(it->second);
      }
    }
  };
  compute(dst, src, in_ports);   // in-ports: group by destination
  compute(src, dst, out_ports);  // out-ports: group by source
}

}  // extern "C"
