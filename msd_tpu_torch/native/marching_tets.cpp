// Native marching-tetrahedra backend.
//
// C-ABI library called from msd_tpu/ops/marching_cubes.py via ctypes —
// replaces the vectorized-numpy hot path (edge hashing + top-level sort
// dominate there). Single pass over active blocks with an open-addressing
// edge->vertex hash map; ~10x the numpy path.
//
// Semantics identical to the Python implementation (same 6-tet cube
// decomposition, same case emission order, same orientation flip table —
// see msd_tpu/ops/marching_cubes.py) and validated against it in
// tests/test_native_mt.py.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

// Cube corner offsets, index = 4x + 2y + z (matches _CORNERS)
const int CORNERS[8][3] = {
    {0, 0, 0}, {0, 0, 1}, {0, 1, 0}, {0, 1, 1},
    {1, 0, 0}, {1, 0, 1}, {1, 1, 0}, {1, 1, 1},
};

// 6-tet decomposition around the 0-7 diagonal (matches _TETS)
const int TETS[6][4] = {
    {0, 4, 5, 7}, {0, 5, 1, 7}, {0, 1, 3, 7},
    {0, 3, 2, 7}, {0, 2, 6, 7}, {0, 6, 4, 7},
};

struct EdgeMap {
  // open addressing, power-of-two capacity; key and value share one
  // 16-byte entry so a probe costs ONE cache line (the map is far beyond
  // LLC on big shells — two parallel arrays measured ~2x the misses)
  struct Entry {
    uint64_t key;
    int64_t val;  // -1 = empty
  };
  std::vector<Entry> slots;
  size_t mask;
  size_t count = 0;

  explicit EdgeMap(size_t expected) {
    size_t cap = 64;
    while (cap < expected * 2) cap <<= 1;
    slots.assign(cap, Entry{UINT64_MAX, -1});
    mask = cap - 1;
  }

  void grow() {
    EdgeMap bigger(slots.size());
    for (size_t i = 0; i < slots.size(); i++) {
      if (slots[i].key != UINT64_MAX) bigger.insert_raw(slots[i].key, (int32_t)slots[i].val);
    }
    slots.swap(bigger.slots);
    mask = bigger.mask;
  }

  void insert_raw(uint64_t k, int32_t v) {
    size_t h = (k * 0x9E3779B97F4A7C15ULL) & mask;
    while (slots[h].key != UINT64_MAX) h = (h + 1) & mask;
    slots[h].key = k;
    slots[h].val = v;
    count++;
  }

  // returns existing id or -1-new_id if inserted
  int32_t get_or_insert(uint64_t k, int32_t next_id) {
    if (count * 2 >= slots.size()) grow();
    size_t h = (k * 0x9E3779B97F4A7C15ULL) & mask;
    while (true) {
      if (slots[h].key == UINT64_MAX) {
        slots[h].key = k;
        slots[h].val = next_id;
        count++;
        return -1 - next_id;
      }
      if (slots[h].key == k) return (int32_t)slots[h].val;
      h = (h + 1) & mask;
    }
  }
};

struct Builder {
  std::vector<float> verts;     // xyz triples (grid-index space)
  std::vector<int32_t> faces;   // triangles
  EdgeMap edges;                // global map: block-BOUNDARY edges only
  int64_t N;
  const uint8_t* flips;
  int64_t deltas[13];           // possible hi-lo values for cell-corner edges
  int n_deltas = 0;
  // per-corner-pair edge code table (code of |id(a)-id(b)| for cube corners)
  int code_tab[8][8];
  // global-id offset of each cube corner relative to corner 0 (fixed per N)
  int64_t corner_delta[8];
  // current block's fine-grid base (set per block): new-vertex positions
  // are base + local lattice coords — no div/mod chain on the global id
  int64_t base[3] = {0, 0, 0};

  // Block-local edge cache (stamp-versioned so no per-block clearing):
  // local edges are deduped in this L1/L2-resident array; the global hash
  // map is consulted only for edges lying on a block face (shared with a
  // neighboring block). Sized at first add_blocks call for the block size.
  std::vector<int32_t> local_ids;
  std::vector<int32_t> local_stamp;
  int32_t stamp = 0;
  int local_bp = 0;

  // Incremental PLY spill: vertex/face data written to temp files as blocks
  // are meshed (on the caller's worker thread, overlapped with device
  // transfers), so the final .ply write is just header + two file copies.
  FILE* spill_fv = nullptr;
  FILE* spill_ff = nullptr;
  size_t spilled_v = 0;  // floats already spilled from verts
  size_t spilled_f = 0;  // int32s already spilled from faces
  float spill_scale = 1.0f;
  float spill_off = 0.0f;
  bool spill_error = false;  // a spill fwrite came up short (e.g. tmpfs full)
  ~Builder() {
    if (spill_fv) fclose(spill_fv);
    if (spill_ff) fclose(spill_ff);
  }

  Builder(size_t expected_edges, int64_t n, const uint8_t* flip)
      : edges(expected_edges), N(n), flips(flip) {
    // typical shells run ~21 verts / 41 tris per CROSSING block, but
    // expected_edges derives from the ACTIVE-block upper bound (crossing
    // runs ~0.4 of active) — reserve at half the bound so the common case
    // still avoids mid-stream reallocation without committing ~2.5x the
    // final geometry memory per mesh; a fatter-than-usual shell costs at
    // most one amortized vector growth
    verts.reserve((expected_edges / 32) * 24 * 3);
    faces.reserve((expected_edges / 32) * 48 * 3);
    // enumerate positive deltas dx*N^2 + dy*N + dz, d* in {-1,0,1}
    for (int dx = -1; dx <= 1; dx++)
      for (int dy = -1; dy <= 1; dy++)
        for (int dz = -1; dz <= 1; dz++) {
          int64_t d = (int64_t)dx * N * N + (int64_t)dy * N + dz;
          if (d > 0 && n_deltas < 13) deltas[n_deltas++] = d;  // exactly 13
        }
    for (int a = 0; a < 8; a++)
      for (int b = 0; b < 8; b++) {
        int64_t d = ((int64_t)(CORNERS[a][0] - CORNERS[b][0]) * N +
                     (CORNERS[a][1] - CORNERS[b][1])) * N +
                    (CORNERS[a][2] - CORNERS[b][2]);
        code_tab[a][b] = delta_code(d < 0 ? -d : d);
      }
    for (int c = 0; c < 8; c++)
      corner_delta[c] =
          ((int64_t)CORNERS[c][0] * N + CORNERS[c][1]) * N + CORNERS[c][2];
    build_cell_cases();
  }

  inline int delta_code(int64_t d) {
    for (int i = 0; i < n_deltas; i++)
      if (deltas[i] == d) return i;
    return 13;  // unreachable for valid cell edges
  }


  // ---- table-driven cell dispatch (round 5) ----
  // For each of the 256 corner-sign masks the tet decomposition's outcome
  // is fully determined: which edges get a vertex and which triangles are
  // emitted. Precomputing it (a) removes the 6x per-cell tet branching and
  // subset extraction from the hot loop, and (b) dedups edges shared by
  // adjacent tets of the SAME cell at table-build time, so cedge (and its
  // stamp-cache probe) runs once per unique edge instead of once per tet
  // reference (~2x fewer probes on typical shells).
  //
  // Byte-identity with the per-tet code is by construction: the builder
  // below walks tets t=0..5 with the exact per-case edge order of the old
  // process_tet, appending unique edges in first-appearance order — every
  // edge reference is inside-corner-first in both versions (sa<0), so
  // interpolation direction, vertex-creation order, and triangle order are
  // all unchanged (pinned by tests/test_streaming_mesh bit-identity).
  struct CellCase {
    uint8_t n_edges = 0, n_tris = 0;
    uint8_t ea[19], eb[19];  // corner-index pairs, inside corner first
    uint8_t lo_c[19];        // min corner index (the lower global id)
    uint8_t code[19];        // |delta| code of the pair (code_tab)
    uint8_t face_cand[19];   // 6-bit mask: block faces this edge CAN lie in
                             // (bit 2*ax = low face needs cell coord 0,
                             //  bit 2*ax+1 = high face needs coord b-1)
    uint8_t tri[36];         // n_tris x 3 edge-slot indices
    uint8_t flip[12];
  };
  CellCase cell_cases[256];
  // local-cache key delta per (mask, slot): cellkey + delta = the stamp
  // cache key of the slot's lo corner + code. bp-dependent, rebuilt by
  // begin_block when the block size changes.
  std::vector<int32_t> lkey_delta;  // [256 * 19]

  void build_lkey_deltas(int bp) {
    lkey_delta.assign(256 * 19, 0);
    for (int m = 1; m < 255; m++) {
      const CellCase& cc = cell_cases[m];
      for (int e = 0; e < cc.n_edges; e++) {
        const int* d = CORNERS[cc.lo_c[e]];
        lkey_delta[m * 19 + e] =
            (int32_t)(((d[0] * bp + d[1]) * bp + d[2]) * 14 + cc.code[e]);
      }
    }
  }

  void build_cell_cases() {
    for (int m = 1; m < 255; m++) {
      CellCase& cc = cell_cases[m];
      auto slot = [&](int ca, int cb) -> int {
        for (int i = 0; i < cc.n_edges; i++)
          if (cc.ea[i] == ca && cc.eb[i] == cb) return i;
        cc.ea[cc.n_edges] = (uint8_t)ca;
        cc.eb[cc.n_edges] = (uint8_t)cb;
        cc.lo_c[cc.n_edges] = (uint8_t)(ca < cb ? ca : cb);
        cc.code[cc.n_edges] = (uint8_t)code_tab[ca][cb];
        uint8_t fc = 0;
        for (int ax = 0; ax < 3; ax++) {
          if (CORNERS[ca][ax] == CORNERS[cb][ax]) {
            // shared-plane candidate: low face iff offset 0, high iff 1
            fc |= (uint8_t)(1u << (2 * ax + CORNERS[ca][ax]));
          }
        }
        cc.face_cand[cc.n_edges] = fc;
        return cc.n_edges++;
      };
      auto tri = [&](int e0, int e1, int e2, uint8_t f) {
        cc.tri[cc.n_tris * 3 + 0] = (uint8_t)e0;
        cc.tri[cc.n_tris * 3 + 1] = (uint8_t)e1;
        cc.tri[cc.n_tris * 3 + 2] = (uint8_t)e2;
        cc.flip[cc.n_tris++] = f;
      };
      for (int t = 0; t < 6; t++) {
        const int* cs = TETS[t];
        bool in[4];
        int subset = 0, n_in = 0;
        for (int v = 0; v < 4; v++) {
          in[v] = (m >> cs[v]) & 1u;
          if (in[v]) {
            subset |= 1 << v;
            n_in++;
          }
        }
        if (n_in == 0 || n_in == 4) continue;
        const uint8_t* F = flips + ((size_t)t * 16 + subset) * 2;
        if (n_in == 1) {
          int v = 0;
          while (!in[v]) v++;
          int o[3], k = 0;
          for (int i = 0; i < 4; i++)
            if (i != v) o[k++] = i;
          tri(slot(cs[v], cs[o[0]]), slot(cs[v], cs[o[1]]),
              slot(cs[v], cs[o[2]]), F[0]);
        } else if (n_in == 3) {
          int v = 0;
          while (in[v]) v++;
          int o[3], k = 0;
          for (int i = 0; i < 4; i++)
            if (i != v) o[k++] = i;
          tri(slot(cs[o[0]], cs[v]), slot(cs[o[1]], cs[v]),
              slot(cs[o[2]], cs[v]), F[0]);
        } else {
          // 2-2: quad in cyclic order (v0,o0), (v0,o1), (v1,o1), (v1,o0)
          int vi[2], oi[2], a = 0, b = 0;
          for (int i = 0; i < 4; i++) {
            if (in[i]) vi[a++] = i;
            else oi[b++] = i;
          }
          int q0 = slot(cs[vi[0]], cs[oi[0]]);
          int q1 = slot(cs[vi[0]], cs[oi[1]]);
          int q2 = slot(cs[vi[1]], cs[oi[1]]);
          int q3 = slot(cs[vi[1]], cs[oi[0]]);
          tri(q0, q1, q2, F[0]);
          tri(q0, q2, q3, F[1]);
        }
      }
    }
  }

  void begin_block(int bp) {
    if (local_bp != bp) {
      local_bp = bp;
      local_ids.assign((size_t)bp * bp * bp * 14, -1);
      local_stamp.assign((size_t)bp * bp * bp * 14, -1);
      stamp = 0;
      build_lkey_deltas(bp);
    }
    stamp++;
  }

  // Table-slot edge vertex: all per-edge derivations (cache key, lo id,
  // boundary test, endpoint coords) come precomputed from the CellCase,
  // so the hot path is a stamp probe plus, for new vertices only, the
  // interpolation. Semantics identical to edge_vertex (same keys, same
  // inside-first interpolation direction).
  inline int32_t edge_slot_vertex(const CellCase& cc, int e, int32_t cellkey,
                                  unsigned facemask, int64_t id0,
                                  const double* sdf, const int* cellc,
                                  const int32_t* ldel) {
    const size_t lkey = (size_t)(cellkey + ldel[e]);
    if (local_stamp[lkey] == stamp) return local_ids[lkey];
    int32_t next_id = (int32_t)(verts.size() / 3);
    if (cc.face_cand[e] & facemask) {
      const uint64_t key =
          (uint64_t)(id0 + corner_delta[cc.lo_c[e]]) * 14 + cc.code[e];
      int32_t got = edges.get_or_insert(key, next_id);
      if (got >= 0) {
        local_ids[lkey] = got;
        local_stamp[lkey] = stamp;
        return got;
      }
    }
    local_ids[lkey] = next_id;
    local_stamp[lkey] = stamp;
    const int a_c = cc.ea[e], b_c = cc.eb[e];
    const double sa = sdf[a_c], sb = sdf[b_c];
    double denom = sb - sa;
    if (std::fabs(denom) < 1e-12) denom = 1e-12;
    double t = (0.0 - sa) / denom;
    if (t < 0) t = 0;
    if (t > 1) t = 1;
    for (int ax = 0; ax < 3; ax++) {
      const double p0 = (double)(base[ax] + cellc[ax] + CORNERS[a_c][ax]);
      const double p1 = (double)(base[ax] + cellc[ax] + CORNERS[b_c][ax]);
      verts.push_back((float)(p0 + t * (p1 - p0)));
    }
    return next_id;
  }

  inline void emit_tri(int32_t v0, int32_t v1, int32_t v2, bool flip) {
    if (v0 == v1 || v1 == v2 || v0 == v2) return;
    if (flip) {
      faces.push_back(v0);
      faces.push_back(v2);
      faces.push_back(v1);
    } else {
      faces.push_back(v0);
      faces.push_back(v1);
      faces.push_back(v2);
    }
  }

};

}  // namespace

static void add_blocks_impl(
    Builder& builder,
    const float* block_vals,
    const int32_t* bases,
    int64_t num_blocks,
    int32_t b,
    int64_t N) {
  const int bp = b + 1;
  const int64_t pts_per = (int64_t)bp * bp * bp;
  // per-(x,y)-row sign masks (bit z = sdf < 0): most cells even of a
  // CROSSING block are uncut (~79% on a 512^3 sphere shell). A cell's
  // 8-corner mask assembles from 4 row masks with shifts, and whole
  // uncut cells reject on 2-bit tests of the rows' OR/AND — no per-cell
  // byte loads at all (round-4's byte-array precount was ~1.4x; this
  // removes its remaining loads).
  if (bp > 64) return;  // row masks are uint64 (bp is 5 in practice)
  std::vector<uint64_t> rowm((size_t)bp * bp);
  const uint64_t full = (bp == 64) ? ~0ull : ((1ull << bp) - 1);
  for (int64_t blk = 0; blk < num_blocks; blk++) {
    const float* vals = block_vals + blk * pts_per;
    const int64_t bx = bases[blk * 3 + 0];
    const int64_t by = bases[blk * 3 + 1];
    const int64_t bz = bases[blk * 3 + 2];
    uint64_t any_bits = 0;
    bool all_in = true;
    for (int x = 0; x < bp; x++)
      for (int y = 0; y < bp; y++) {
        const float* v = vals + ((size_t)x * bp + y) * bp;
        uint64_t r = 0;
        for (int z = 0; z < bp; z++) r |= (uint64_t)(v[z] < 0.0f) << z;
        rowm[(size_t)x * bp + y] = r;
        any_bits |= r;
        all_in &= (r == full);
      }
    if (any_bits == 0 || all_in) continue;
    builder.begin_block(bp);
    builder.base[0] = bx;
    builder.base[1] = by;
    builder.base[2] = bz;
    for (int ci = 0; ci < b; ci++) {
      for (int cj = 0; cj < b; cj++) {
        const uint64_t r00 = rowm[(size_t)ci * bp + cj];
        const uint64_t r01 = rowm[(size_t)ci * bp + cj + 1];
        const uint64_t r10 = rowm[(size_t)(ci + 1) * bp + cj];
        const uint64_t r11 = rowm[(size_t)(ci + 1) * bp + cj + 1];
        const uint64_t u = r00 | r01 | r10 | r11;   // any corner inside
        const uint64_t a = r00 & r01 & r10 & r11;   // all corners inside
        if (u == 0 || a == full) continue;  // whole (ci,cj) column un-cut
        for (int ck = 0; ck < b; ck++) {
          // cut iff some-but-not-all of the cell's 8 corners are inside:
          // 2-bit window [ck, ck+1] of the row OR/ANDs decides it before
          // any mask assembly
          const unsigned u2 = (unsigned)(u >> ck) & 3u;
          if (u2 == 0u) continue;
          if (((unsigned)(a >> ck) & 3u) == 3u) continue;
          // inside bitmask over the cell's 8 corners, bit index 4x+2y+z
          // (the corner order of CORNERS/_CORNERS)
          const unsigned m =
              ((unsigned)(r00 >> ck) & 3u) | (((unsigned)(r01 >> ck) & 3u) << 2) |
              (((unsigned)(r10 >> ck) & 3u) << 4) |
              (((unsigned)(r11 >> ck) & 3u) << 6);
          if (m == 0u || m == 255u) continue;
          // gather the 8 corner values of this cut cell; ids/coords come
          // from per-slot table data (corner-0 id + fixed deltas)
          const int64_t id0 = ((bx + ci) * N + (by + cj)) * N + (bz + ck);
          double s[8];
          {
            const float* v0 = vals + ((size_t)ci * bp + cj) * bp + ck;
            s[0] = (double)v0[0];
            s[1] = (double)v0[1];
            s[2] = (double)v0[bp];
            s[3] = (double)v0[bp + 1];
            s[4] = (double)v0[(size_t)bp * bp];
            s[5] = (double)v0[(size_t)bp * bp + 1];
            s[6] = (double)v0[(size_t)bp * bp + bp];
            s[7] = (double)v0[(size_t)bp * bp + bp + 1];
          }
          const int cellc[3] = {ci, cj, ck};
          const int32_t cellkey =
              (int32_t)((((size_t)ci * bp + cj) * bp + ck) * 14);
          const unsigned facemask =
              (unsigned)(ci == 0) | ((unsigned)(ci == b - 1) << 1) |
              ((unsigned)(cj == 0) << 2) | ((unsigned)(cj == b - 1) << 3) |
              ((unsigned)(ck == 0) << 4) | ((unsigned)(ck == b - 1) << 5);
          const Builder::CellCase& cc = builder.cell_cases[m];
          const int32_t* ldel = &builder.lkey_delta[(size_t)m * 19];
          // prefetch the hash slots of boundary-candidate edges: the map
          // is far beyond LLC, and the per-edge work between prefetch and
          // probe hides part of the DRAM latency
          if (facemask) {
            for (int e = 0; e < cc.n_edges; e++)
              if (cc.face_cand[e] & facemask) {
                const uint64_t key =
                    (uint64_t)(id0 + builder.corner_delta[cc.lo_c[e]]) * 14 +
                    cc.code[e];
                __builtin_prefetch(
                    &builder.edges.slots[(key * 0x9E3779B97F4A7C15ULL) &
                                         builder.edges.mask]);
              }
          }
          int32_t ev[19];
          for (int e = 0; e < cc.n_edges; e++)
            ev[e] = builder.edge_slot_vertex(cc, e, cellkey, facemask, id0,
                                             s, cellc, ldel);
          const uint8_t* tp = cc.tri;
          for (int f = 0; f < cc.n_tris; f++, tp += 3)
            builder.emit_tri(ev[tp[0]], ev[tp[1]], ev[tp[2]], cc.flip[f]);
        }
      }
    }
  }
}

extern "C" {

// ---- streaming builder API (overlap host meshing with device eval) ----

void* mt_create(int64_t N, const uint8_t* flips, int64_t expected_blocks) {
  // flips must outlive the handle (the Python side keeps it alive)
  return new Builder((size_t)expected_blocks * 16 + 1024, N, flips);
}

static void spill_new_geometry(Builder& b) {
  if (b.spill_error) return;
  if (b.spill_fv) {
    size_t n = b.verts.size();
    if (n > b.spilled_v) {
      float buf[3072];
      size_t i = b.spilled_v;
      while (i < n) {
        size_t c = n - i < 3072 ? n - i : 3072;
        for (size_t j = 0; j < c; j++) buf[j] = b.verts[i + j] * b.spill_scale + b.spill_off;
        if (fwrite(buf, sizeof(float), c, b.spill_fv) != c) { b.spill_error = true; return; }
        i += c;
      }
      b.spilled_v = n;
    }
  }
  if (b.spill_ff) {
    size_t n = b.faces.size();
    if (n > b.spilled_f) {
      // PLY face row: uchar 3 + 3x int32 = 13 bytes
      unsigned char buf[13 * 256];
      size_t i = b.spilled_f;
      while (i < n) {
        size_t c = (n - i) / 3 < 256 ? (n - i) / 3 : 256;
        for (size_t j = 0; j < c; j++) {
          unsigned char* p = buf + 13 * j;
          p[0] = 3;
          memcpy(p + 1, &b.faces[i + 3 * j], 12);
        }
        if (fwrite(buf, 13, c, b.spill_ff) != c) { b.spill_error = true; return; }
        i += 3 * c;
      }
      b.spilled_f = i;
    }
  }
}

void mt_add_blocks(
    void* handle, const float* block_vals, const int32_t* bases,
    int64_t num_blocks, int32_t b) {
  Builder* builder = (Builder*)handle;
  add_blocks_impl(*builder, block_vals, bases, num_blocks, b, builder->N);
  spill_new_geometry(*builder);
}

// Begin streaming PLY output: vertex/face payloads spill to the two temp
// paths during mt_add_blocks; mt_ply_stream_finish assembles the final file.
int mt_ply_stream_begin(
    void* handle, const char* vert_path, const char* face_path,
    float scale, float offset) {
  Builder* builder = (Builder*)handle;
  builder->spill_fv = fopen(vert_path, "w+b");
  builder->spill_ff = fopen(face_path, "w+b");
  if (!builder->spill_fv || !builder->spill_ff) return -1;
  setvbuf(builder->spill_fv, nullptr, _IOFBF, 1 << 20);
  setvbuf(builder->spill_ff, nullptr, _IOFBF, 1 << 20);
  builder->spill_scale = scale;
  builder->spill_off = offset;
  return 0;
}

// Write header + concatenate the spilled payloads into final_path.
// Does NOT destroy the builder (callers still read the in-memory mesh).
int mt_ply_stream_finish(void* handle, const char* final_path) {
  Builder* builder = (Builder*)handle;
  if (!builder->spill_fv || !builder->spill_ff) return -1;
  spill_new_geometry(*builder);
  if (builder->spill_error) return -1;
  FILE* out = fopen(final_path, "wb");
  if (!out) return -1;
  setvbuf(out, nullptr, _IOFBF, 1 << 20);
  char header[256];
  int hn = snprintf(
      header, sizeof(header),
      "ply\nformat binary_little_endian 1.0\n"
      "element vertex %lld\nproperty float x\nproperty float y\nproperty float z\n"
      "element face %lld\nproperty list uchar int vertex_indices\nend_header\n",
      (long long)(builder->verts.size() / 3), (long long)(builder->faces.size() / 3));
  int rc0 = fwrite(header, 1, (size_t)hn, out) == (size_t)hn ? 0 : -1;
  static thread_local std::vector<char> buf(1 << 20);
  FILE* parts[2] = {builder->spill_fv, builder->spill_ff};
  int rc = rc0;
  for (int p = 0; p < 2; p++) {
    fflush(parts[p]);
    rewind(parts[p]);
    size_t n;
    while ((n = fread(buf.data(), 1, buf.size(), parts[p])) > 0) {
      if (fwrite(buf.data(), 1, n, out) != n) { rc = -1; break; }
    }
    fclose(parts[p]);
  }
  builder->spill_fv = nullptr;
  builder->spill_ff = nullptr;
  if (fclose(out) != 0) rc = -1;
  return rc;
}

// Zero-copy variant: returns views of the builder's internal buffers.
// The pointers stay valid until mt_destroy(handle); the caller must copy
// (or transform) them out before destroying and must NOT mt_free() them.
int mt_finish_view(
    void* handle,
    float** out_verts, int64_t* out_num_verts,
    int32_t** out_faces, int64_t* out_num_faces) {
  Builder* builder = (Builder*)handle;
  *out_num_verts = (int64_t)(builder->verts.size() / 3);
  *out_num_faces = (int64_t)(builder->faces.size() / 3);
  *out_verts = builder->verts.data();
  *out_faces = builder->faces.data();
  return 0;
}

void mt_destroy(void* handle) { delete (Builder*)handle; }

int mt_finish(
    void* handle,
    float** out_verts, int64_t* out_num_verts,
    int32_t** out_faces, int64_t* out_num_faces) {
  Builder* builder = (Builder*)handle;
  *out_num_verts = (int64_t)(builder->verts.size() / 3);
  *out_num_faces = (int64_t)(builder->faces.size() / 3);
  *out_verts = (float*)malloc(builder->verts.size() * sizeof(float));
  *out_faces = (int32_t*)malloc(builder->faces.size() * sizeof(int32_t));
  int rc = 0;
  if ((!*out_verts && !builder->verts.empty()) || (!*out_faces && !builder->faces.empty()))
    rc = -1;
  else {
    memcpy(*out_verts, builder->verts.data(), builder->verts.size() * sizeof(float));
    memcpy(*out_faces, builder->faces.data(), builder->faces.size() * sizeof(int32_t));
  }
  delete builder;
  return rc;
}

// ---- one-shot API ----

int mt_blocks(
    const float* block_vals,
    const int32_t* bases,
    int64_t num_blocks,
    int32_t b,
    int64_t N,
    const uint8_t* flips,
    float** out_verts,
    int64_t* out_num_verts,
    int32_t** out_faces,
    int64_t* out_num_faces) {
  Builder builder((size_t)num_blocks * 16 + 1024, N, flips);
  add_blocks_impl(builder, block_vals, bases, num_blocks, b, N);
  *out_num_verts = (int64_t)(builder.verts.size() / 3);
  *out_num_faces = (int64_t)(builder.faces.size() / 3);
  *out_verts = (float*)malloc(builder.verts.size() * sizeof(float));
  *out_faces = (int32_t*)malloc(builder.faces.size() * sizeof(int32_t));
  if ((!*out_verts && !builder.verts.empty()) || (!*out_faces && !builder.faces.empty()))
    return -1;
  memcpy(*out_verts, builder.verts.data(), builder.verts.size() * sizeof(float));
  memcpy(*out_faces, builder.faces.data(), builder.faces.size() * sizeof(int32_t));
  return 0;
}

void mt_free(void* p) { free(p); }

}  // extern "C"
