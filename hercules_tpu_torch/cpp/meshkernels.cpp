// Native meshing kernels: Morton interleave, 128-bit key sorting, and
// floor searches — the host-side hot paths of octree meshing at scale
// (the role etree/code.c's generated tables and octor.c's zsearch play
// in the reference, rebuilt as vectorized multithreaded C++).
//
// Exposed with a plain C ABI for ctypes; built by hercules_tpu.native.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint64_t spread3(uint64_t v) {
    // spread the low 21 bits of v to every 3rd bit
    v &= 0x1fffff;
    v = (v | (v << 32)) & 0x1f00000000ffffULL;
    v = (v | (v << 16)) & 0x1f0000ff0000ffULL;
    v = (v | (v << 8))  & 0x100f00f00f00f00fULL;
    v = (v | (v << 4))  & 0x10c30c30c30c30c3ULL;
    v = (v | (v << 2))  & 0x1249249249249249ULL;
    return v;
}

inline uint64_t compact3(uint64_t v) {
    v &= 0x1249249249249249ULL;
    v = (v ^ (v >> 2))  & 0x10c30c30c30c30c3ULL;
    v = (v ^ (v >> 4))  & 0x100f00f00f00f00fULL;
    v = (v ^ (v >> 8))  & 0x1f0000ff0000ffULL;
    v = (v ^ (v >> 16)) & 0x1f00000000ffffULL;
    v = (v ^ (v >> 32)) & 0x1fffffULL;
    return v;
}

inline void interleave_one(uint32_t x, uint32_t y, uint32_t z,
                           uint64_t* hi, uint64_t* lo) {
    // low 21 bits of each coordinate -> morton bits 0..62
    uint64_t lo_part = spread3(x) | (spread3(y) << 1) | (spread3(z) << 2);
    // remaining high bits (21..31) -> morton bits 63..95
    uint64_t xh = x >> 21, yh = y >> 21, zh = z >> 21;
    uint64_t hi_part = spread3(xh) | (spread3(yh) << 1)
        | (spread3(zh) << 2);
    // morton bit 63 belongs to lo; hi_part currently starts at bit 63
    *lo = lo_part | (hi_part << 63);
    *hi = hi_part >> 1;
}

template <class F>
void parallel_for(int64_t n, F f) {
    unsigned nt = std::thread::hardware_concurrency();
    if (nt == 0) nt = 4;
    if (n < 1 << 15 || nt <= 1) { f(0, n); return; }
    std::vector<std::thread> ts;
    int64_t chunk = (n + nt - 1) / nt;
    for (unsigned t = 0; t < nt; t++) {
        int64_t s = t * chunk;
        int64_t e = std::min<int64_t>(n, s + chunk);
        if (s >= e) break;
        ts.emplace_back([=] { f(s, e); });
    }
    for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

void ht_interleave3(const uint32_t* x, const uint32_t* y,
                    const uint32_t* z, uint64_t* hi, uint64_t* lo,
                    int64_t n) {
    parallel_for(n, [&](int64_t s, int64_t e) {
        for (int64_t i = s; i < e; i++)
            interleave_one(x[i], y[i], z[i], &hi[i], &lo[i]);
    });
}

void ht_deinterleave3(const uint64_t* hi, const uint64_t* lo,
                      uint32_t* x, uint32_t* y, uint32_t* z, int64_t n) {
    parallel_for(n, [&](int64_t s, int64_t e) {
        for (int64_t i = s; i < e; i++) {
            uint64_t l = lo[i], h = hi[i];
            uint64_t xlo = compact3(l);
            uint64_t ylo = compact3(l >> 1);
            uint64_t zlo = compact3(l >> 2);
            // morton bits 63.. come from (hi << 1) | (lo >> 63)
            uint64_t hh = (h << 1) | (l >> 63);
            uint64_t xhi = compact3(hh);
            uint64_t yhi = compact3(hh >> 1);
            uint64_t zhi = compact3(hh >> 2);
            x[i] = (uint32_t)(xlo | (xhi << 21));
            y[i] = (uint32_t)(ylo | (yhi << 21));
            z[i] = (uint32_t)(zlo | (zhi << 21));
        }
    });
}

// argsort of 128-bit keys (hi, lo), stable.  LSD radix over 16-bit
// digits (lo: 4 passes, then hi: only the passes its value range
// needs): O(n) per pass beats std::stable_sort's comparison cost
// ~3-4x at mesh-extraction sizes (8M corner keys) on the single-core
// build hosts this runs on.
void ht_sort_perm_u128(const uint64_t* hi, const uint64_t* lo, int64_t n,
                       int64_t* perm) {
    for (int64_t i = 0; i < n; i++) perm[i] = i;
    if (n < (1 << 14)) {              // small: comparison sort wins
        std::stable_sort(perm, perm + n, [&](int64_t a, int64_t b) {
            if (hi[a] != hi[b]) return hi[a] < hi[b];
            return lo[a] < lo[b];
        });
        return;
    }
    uint64_t hi_or = 0, lo_or = 0;
    for (int64_t i = 0; i < n; i++) { hi_or |= hi[i]; lo_or |= lo[i]; }
    std::vector<int64_t> tmp(n);
    int64_t* src = perm;
    int64_t* dst = tmp.data();
    std::vector<int64_t> cnt(1 << 16);
    auto pass = [&](const uint64_t* w, int sh) {
        std::fill(cnt.begin(), cnt.end(), 0);
        for (int64_t i = 0; i < n; i++)
            cnt[(w[src[i]] >> sh) & 0xffff]++;
        int64_t run = 0;
        for (int64_t b = 0; b < (1 << 16); b++) {
            int64_t c = cnt[b];
            cnt[b] = run;
            run += c;
        }
        for (int64_t i = 0; i < n; i++)
            dst[cnt[(w[src[i]] >> sh) & 0xffff]++] = src[i];
        std::swap(src, dst);
    };
    // constant-zero digits need no pass (all-equal digits preserve
    // the stable order)
    for (int sh = 0; sh < 64; sh += 16)
        if ((lo_or >> sh) & 0xffff) pass(lo, sh);
    for (int sh = 0; sh < 64; sh += 16)
        if ((hi_or >> sh) & 0xffff) pass(hi, sh);
    if (src != perm)
        std::copy(src, src + n, perm);
}

// For each sorted-store query: index of last store key <= query, -1 if
// none.  Store must be sorted ascending by (hi, lo).
void ht_floor_search(const uint64_t* shi, const uint64_t* slo, int64_t ns,
                     const uint64_t* qhi, const uint64_t* qlo, int64_t nq,
                     int64_t* out) {
    parallel_for(nq, [&](int64_t s, int64_t e) {
        for (int64_t i = s; i < e; i++) {
            uint64_t qh = qhi[i], ql = qlo[i];
            int64_t lo_i = 0, hi_i = ns;  // [lo_i, hi_i)
            while (lo_i < hi_i) {
                int64_t mid = (lo_i + hi_i) >> 1;
                bool le = (shi[mid] < qh)
                    || (shi[mid] == qh && slo[mid] <= ql);
                if (le) lo_i = mid + 1; else hi_i = mid;
            }
            out[i] = lo_i - 1;
        }
    });
}

// exact-match lookup in a sorted store; -1 when absent
void ht_exact_search(const uint64_t* shi, const uint64_t* slo, int64_t ns,
                     const uint64_t* qhi, const uint64_t* qlo, int64_t nq,
                     int64_t* out) {
    parallel_for(nq, [&](int64_t s, int64_t e) {
        for (int64_t i = s; i < e; i++) {
            uint64_t qh = qhi[i], ql = qlo[i];
            int64_t lo_i = 0, hi_i = ns;
            while (lo_i < hi_i) {
                int64_t mid = (lo_i + hi_i) >> 1;
                bool lt = (shi[mid] < qh)
                    || (shi[mid] == qh && slo[mid] < ql);
                if (lt) lo_i = mid + 1; else hi_i = mid;
            }
            out[i] = (lo_i < ns && shi[lo_i] == qh && slo[lo_i] == ql)
                ? lo_i : -1;
        }
    });
}


// fused etree point lookup (etree.c:563-615 semantics): Morton
// interleave of each query tick coordinate, floor search over the
// sorted leaf keys, hit iff the floor leaf is an ancestor of the
// max-level query key.  One parallel pass instead of three numpy ones.
void ht_etree_search(const uint64_t* shi, const uint64_t* slo,
                     const uint8_t* slevel, int64_t ns,
                     const uint32_t* qx, const uint32_t* qy,
                     const uint32_t* qz, int64_t nq, int64_t* out) {
    parallel_for(nq, [&](int64_t s, int64_t e) {
        for (int64_t i = s; i < e; i++) {
            uint64_t qh, ql;
            interleave_one(qx[i], qy[i], qz[i], &qh, &ql);
            // floor: last stored key <= query key
            int64_t lo_i = 0, hi_i = ns;
            while (lo_i < hi_i) {
                int64_t mid = (lo_i + hi_i) >> 1;
                bool le = (shi[mid] < qh)
                    || (shi[mid] == qh && slo[mid] <= ql);
                if (le) lo_i = mid + 1; else hi_i = mid;
            }
            int64_t f = lo_i - 1;
            if (f < 0) { out[i] = -1; continue; }
            // ancestor at level l shares the top 3*(l+1) of 96 bits
            int nbits = 96 - 3 * ((int)slevel[f] + 1);
            uint64_t xl = shi[f] ^ qh;   // hi words
            uint64_t xo = slo[f] ^ ql;   // lo words
            int lo_bits = nbits < 64 ? nbits : 64;
            int hi_bits = nbits > 64 ? nbits - 64 : 0;
            bool same_lo = lo_bits >= 64 || (xo >> lo_bits) == 0;
            bool same_hi = (xl >> hi_bits) == 0;
            out[i] = (same_lo && same_hi) ? f : -1;
        }
    });
}



// fused 27-point CVM sampling for mesh material assignment.  One pass
// over elements does, per sample point, the EXACT float sequence of
// the numpy path (material.py setrec / correct_properties +
// cvm.py CVM.query) so results are bit-identical:
//   mode 0 (setrec, psolve.c:1307-1397):
//     north = ox + (X + f*half) * ts   (east from Y, depth from Z)
//     min-Vs reduction, first-strictly-smaller wins, any_ok
//   mode 1 (mesh_correct_properties, psolve.c:7104-7200):
//     north = ts*X + edge*f + ox ;  27-sample sums + ok count
// Queries resolve through the dense Morton-cell LUT
// (etree/reader.py _dense_lut) - one shift+spread+gather per point.
void ht_cvm_sample27(
    const double* X, const double* Y, const double* Z,
    const double* half_or_edge, int64_t n,
    double ts, double ox, double oy, double oz, double zshift,
    const double* fr, double cts,
    int64_t epx, int64_t epy, int64_t epz,
    const int32_t* dense, int32_t sh, int64_t cells,
    const double* cvp, const double* cvs, const double* crho,
    int32_t mode,
    double* ovp, double* ovs, double* orho, int32_t* ook) {
    parallel_for(n, [&](int64_t s, int64_t e) {
        for (int64_t i = s; i < e; i++) {
            double he = half_or_edge[i];
            double vs_m = 0.0, vp_m = 0.0, rho_m = 0.0;
            bool any = false;
            double vs_min = 1.0 / 0.0;
            int nok = 0;
            for (int a = 0; a < 3; a++) {
                double north = mode == 0
                    ? ox + (X[i] + fr[a] * he) * ts
                    : ts * X[i] + he * fr[a] + ox;
                for (int b = 0; b < 3; b++) {
                    double east = mode == 0
                        ? oy + (Y[i] + fr[b] * he) * ts
                        : ts * Y[i] + he * fr[b] + oy;
                    for (int c = 0; c < 3; c++) {
                        double depth = (mode == 0
                            ? oz + (Z[i] + fr[c] * he) * ts
                            : ts * Z[i] + he * fr[c] + oz) - zshift;
                        // CVM.query: east->x, north->y, depth->z
                        int64_t qx = (int64_t)(east / cts);
                        int64_t qy = (int64_t)(north / cts);
                        int64_t qz = (int64_t)(depth / cts);
                        bool ok = qx >= 0 && qy >= 0 && qz >= 0
                            && qx < epx && qy < epy && qz < epz;
                        if (ok) {
                            uint64_t cell =
                                spread3((uint64_t)qx >> sh)
                                | (spread3((uint64_t)qy >> sh) << 1)
                                | (spread3((uint64_t)qz >> sh) << 2);
                            // domains can extend past the cell space
                            // (no record covers them): bounds-check
                            ok = cell < (uint64_t)cells;
                            int32_t rec = ok ? dense[cell] : -1;
                            ok = rec >= 0;
                            if (ok) {
                                double vp = cvp[rec], vs = cvs[rec],
                                       rho = crho[rec];
                                if (mode == 0) {
                                    if (vs < vs_min) {
                                        vs_min = vs; vp_m = vp;
                                        rho_m = rho;
                                    }
                                    any = true;
                                } else {
                                    vp_m += vp; vs_m += vs;
                                    rho_m += rho; nok++;
                                }
                            }
                        }
                    }
                }
            }
            if (mode == 0) {
                ovp[i] = any ? vp_m : 0.0;
                ovs[i] = vs_min;
                orho[i] = any ? rho_m : 0.0;
                ook[i] = any ? 1 : 0;
            } else {
                ovp[i] = vp_m; ovs[i] = vs_m; orho[i] = rho_m;
                ook[i] = nok;
            }
        }
    });
}



// fused group-id pass for mesh extraction (extract.py): walk the
// sort permutation once, assign each ORIGINAL corner its node id
// (= rank of its distinct key) and flag the first corner of each
// group.  Replaces two full-key gathers + a cumsum + an int64
// scatter (each O(8E) random-access numpy passes) with one pass.
// Serial by construction (the running group id), but single-pass.
void ht_group_ids(const uint64_t* hi, const uint64_t* lo,
                  const int64_t* order, int64_t n,
                  int32_t* gid, uint8_t* first) {
    int64_t g = -1;
    uint64_t ph = 0, pl = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t j = order[i];
        if (g < 0 || hi[j] != ph || lo[j] != pl) {
            g++;
            first[i] = 1;
            ph = hi[j];
            pl = lo[j];
        } else {
            first[i] = 0;
        }
        gid[j] = (int32_t)g;
    }
}


// fused 2:1-balance probe scan (octor_balancetree semantics,
// octor.c:4397-4776): for each SOURCE leaf, probe one tick into each
// of the 26 neighbor regions, floor-search the sorted leaf keys, and
// mark any containing leaf more than one level coarser for
// splitting.  Replaces the numpy pipeline that materialized 26
// probe-coordinate arrays (~7 GB at 11M leaves) per sweep.
void ht_balance_scan(const uint64_t* shi, const uint64_t* slo,
                     const uint8_t* slevel, int64_t n,
                     const int64_t* src, int64_t nsrc,
                     int64_t fx, int64_t fy, int64_t fz,
                     int64_t minlv,
                     uint8_t* split, uint8_t* trig) {
    parallel_for(nsrc, [&](int64_t s0, int64_t e0) {
        for (int64_t si = s0; si < e0; si++) {
            int64_t i = src[si];
            int L = slevel[i];
            // a violation needs a containing leaf at level < L-1;
            // sources at the two coarsest levels can never find one
            if (L < (int)minlv + 2) continue;
            uint64_t l = slo[i], h = shi[i];
            uint64_t hh = (h << 1) | (l >> 63);
            int64_t x = (int64_t)(uint32_t)(compact3(l)
                                            | (compact3(hh) << 21));
            int64_t y = (int64_t)(uint32_t)(compact3(l >> 1)
                                            | (compact3(hh >> 1) << 21));
            int64_t z = (int64_t)(uint32_t)(compact3(l >> 2)
                                            | (compact3(hh >> 2) << 21));
            int64_t e = (int64_t)1 << (30 - L);
            for (int dx = -1; dx <= 1; dx++)
                for (int dy = -1; dy <= 1; dy++)
                    for (int dz = -1; dz <= 1; dz++) {
                        if (dx == 0 && dy == 0 && dz == 0) continue;
                        int64_t px = x + (dx < 0 ? -1 : dx == 0 ? 0 : e);
                        int64_t py = y + (dy < 0 ? -1 : dy == 0 ? 0 : e);
                        int64_t pz = z + (dz < 0 ? -1 : dz == 0 ? 0 : e);
                        if (px < 0 || py < 0 || pz < 0
                            || px >= fx || py >= fy || pz >= fz)
                            continue;
                        uint64_t qh, ql;
                        interleave_one((uint32_t)px, (uint32_t)py,
                                       (uint32_t)pz, &qh, &ql);
                        // floor search SEEDED at the source leaf:
                        // probes sit one tick outside the leaf, so
                        // in Morton order the floor is usually
                        // within a few positions of i — gallop
                        // out from i, then binary-search the
                        // bracketed range (exact same floor as the
                        // full binary search, ~4-8 probes instead
                        // of log2(11M) = 24 cache-missing ones)
                        auto le = [&](int64_t m) {
                            return (shi[m] < qh)
                                || (shi[m] == qh && slo[m] <= ql);
                        };
                        int64_t a, b;   // le(a) (or a==-1), !le(b) (or b==n)
                        if (le(i)) {
                            a = i;
                            int64_t step = 1;
                            while (a + step < n && le(a + step)) {
                                a += step;
                                step <<= 1;
                            }
                            b = a + step < n ? a + step : n;
                        } else {
                            b = i;
                            a = i - 1;
                            int64_t step = 1;
                            while (a >= 0 && !le(a)) {
                                b = a;
                                a -= step;
                                step <<= 1;
                            }
                            if (a < 0) a = -1;
                        }
                        while (a + 1 < b) {
                            int64_t mid = (a + b) >> 1;
                            if (le(mid)) a = mid; else b = mid;
                        }
                        int64_t f = a;
                        if (f >= 0 && (int)slevel[f] < L - 1) {
                            // containment check: on interval-sharded
                            // trees the key space has gaps, so the
                            // floor leaf may not actually contain the
                            // probe point (a probe past the shard's
                            // interval end floors onto its last
                            // leaf).  A level-Lf leaf's key covers
                            // exactly the keys matching its top bits
                            // above 3*(30-Lf).
                            int free_b = 3 * (30 - (int)slevel[f]);
                            uint64_t xl = ql ^ slo[f];
                            uint64_t xh = qh ^ shi[f];
                            bool same_lo = free_b >= 64
                                || (xl >> free_b) == 0;
                            int hib = free_b > 64 ? free_b - 64 : 0;
                            bool same_hi = (xh >> hib) == 0;
                            if (same_lo && same_hi) {
                                split[f] = 1;
                                // re-probe this source next sweep:
                                // one split may not close a
                                // multi-level gap
                                trig[si] = 1;
                            }
                        }
                    }
        }
    });
}


// fused dangling-node candidate scan for mesh extraction
// (extract.py / octor.c:3867-3912 dnode_correlate semantics): for
// each coarse element emit its 12 edge-midpoint and 6 face-center
// candidates — node index (exact search over the sorted node keys,
// far-boundary clamped) and, when present, the anchor corner node
// indices.  One pass instead of ~30 numpy candidate/anchor lookup
// batches with materialized coordinate arrays.
// Candidate order per element: edges (axis-major, f1, f2) then faces
// (axis, f) — extract.py's case order.
void ht_dangling_scan(const uint64_t* nhi, const uint64_t* nlo,
                      int64_t nn,
                      const uint32_t* bx, const uint32_t* by,
                      const uint32_t* bz, const int64_t* be,
                      int64_t nb,
                      int64_t fx, int64_t fy, int64_t fz,
                      int64_t* out_nid, int64_t* out_anc,
                      uint8_t* out_deps) {
    // galloped exact search seeded near the element's own corner-0
    // node: candidates sit inside the element, so in Morton order
    // their node rows are within a short range of the corner's —
    // ~4-8 probes instead of log2(nn) cache-missing ones.  Elements
    // are Morton-sorted, so the per-element seed itself gallops from
    // the previous element's in O(1) amortized.
    auto lbound_from = [&](int64_t seed, uint64_t qh,
                           uint64_t ql) -> int64_t {
        auto ltf = [&](int64_t m) {
            return (nhi[m] < qh) || (nhi[m] == qh && nlo[m] < ql);
        };
        if (seed < 0) seed = 0;
        if (seed >= nn) seed = nn - 1;
        int64_t a, b, st = 1;
        if (ltf(seed)) {
            a = seed;
            while (a + st < nn && ltf(a + st)) { a += st; st <<= 1; }
            b = (a + st < nn) ? a + st : nn;
        } else {
            b = seed;
            a = seed - 1;
            while (a >= 0 && !ltf(a)) { b = a; a -= st; st <<= 1; }
            if (a < 0) a = -1;
        }
        while (a + 1 < b) {
            int64_t mid = (a + b) >> 1;
            if (ltf(mid)) a = mid; else b = mid;
        }
        return b;          // first index with key >= q
    };
    parallel_for(nb, [&](int64_t s, int64_t e0) {
        int64_t run_seed = 0;
        int64_t seed = 0;
        auto find = [&](int64_t cx, int64_t cy, int64_t cz) -> int64_t {
            if (cx > fx - 1) cx = fx - 1;
            if (cy > fy - 1) cy = fy - 1;
            if (cz > fz - 1) cz = fz - 1;
            uint64_t qh, ql;
            interleave_one((uint32_t)cx, (uint32_t)cy, (uint32_t)cz,
                           &qh, &ql);
            int64_t lb = lbound_from(seed, qh, ql);
            return (lb < nn && nhi[lb] == qh && nlo[lb] == ql)
                ? lb : -1;
        };
        for (int64_t i = s; i < e0; i++) {
            int64_t x = bx[i], y = by[i], z = bz[i];
            int64_t e = be[i], h = e >> 1;
            {
                // per-element seed: lower bound of corner 0's key,
                // galloped from the previous element's seed
                int64_t cx = x > fx - 1 ? fx - 1 : x;
                int64_t cy = y > fy - 1 ? fy - 1 : y;
                int64_t cz = z > fz - 1 ? fz - 1 : z;
                uint64_t qh, ql;
                interleave_one((uint32_t)cx, (uint32_t)cy,
                               (uint32_t)cz, &qh, &ql);
                run_seed = lbound_from(run_seed, qh, ql);
                if (run_seed >= nn) run_seed = nn - 1;
                seed = run_seed;
            }
            int ci = 0;
            for (int axis = 0; axis < 3; axis++)
                for (int f1 = 0; f1 < 2; f1++)
                    for (int f2 = 0; f2 < 2; f2++) {
                        int a = (axis + 1) % 3, b = (axis + 2) % 3;
                        int64_t off[3];
                        off[axis] = h;
                        off[a] = (int64_t)f1 * e;
                        off[b] = (int64_t)f2 * e;
                        int64_t r = i * 18 + ci++;
                        int64_t nid = find(x + off[0], y + off[1],
                                           z + off[2]);
                        out_nid[r] = nid;
                        out_deps[r] = 2;
                        out_anc[r * 4 + 2] = -1;
                        out_anc[r * 4 + 3] = -1;
                        if (nid >= 0) {
                            int64_t lo_o[3] = {off[0], off[1], off[2]};
                            int64_t hi_o[3] = {off[0], off[1], off[2]};
                            lo_o[axis] = 0;
                            hi_o[axis] = e;
                            out_anc[r * 4 + 0] = find(
                                x + lo_o[0], y + lo_o[1], z + lo_o[2]);
                            out_anc[r * 4 + 1] = find(
                                x + hi_o[0], y + hi_o[1], z + hi_o[2]);
                        } else {
                            out_anc[r * 4 + 0] = -1;
                            out_anc[r * 4 + 1] = -1;
                        }
                    }
            for (int axis = 0; axis < 3; axis++)
                for (int f = 0; f < 2; f++) {
                    int64_t off[3] = {h, h, h};
                    off[axis] = (int64_t)f * e;
                    int64_t r = i * 18 + ci++;
                    int64_t nid = find(x + off[0], y + off[1],
                                       z + off[2]);
                    out_nid[r] = nid;
                    out_deps[r] = 4;
                    if (nid >= 0) {
                        int a = (axis + 1) % 3, b = (axis + 2) % 3;
                        int k = 0;
                        for (int c1 = 0; c1 < 2; c1++)
                            for (int c2 = 0; c2 < 2; c2++) {
                                int64_t co[3];
                                co[axis] = (int64_t)f * e;
                                co[a] = (int64_t)c1 * e;
                                co[b] = (int64_t)c2 * e;
                                out_anc[r * 4 + k++] = find(
                                    x + co[0], y + co[1], z + co[2]);
                            }
                    } else {
                        for (int k = 0; k < 4; k++)
                            out_anc[r * 4 + k] = -1;
                    }
                }
        }
    });
}


// corner Morton keys for mesh extraction (extract.py): for element i
// with corner (x, y, z) and edge e, emit the 8 corner keys
// (which-order: bit0 = x, bit1 = y, bit2 = z, octor.c:1583-1588) with
// far-boundary clamping (octor.c:6100-6106), interleaved in one pass —
// no 8E-sized numpy temporaries.
void ht_corner_keys(const uint32_t* x, const uint32_t* y,
                    const uint32_t* z, const int64_t* e, int64_t n,
                    int64_t fx, int64_t fy, int64_t fz,
                    uint64_t* hi, uint64_t* lo) {
    parallel_for(n, [&](int64_t s, int64_t en) {
        for (int64_t i = s; i < en; i++) {
            int64_t ee = e[i];
            for (int j = 0; j < 8; j++) {
                int64_t cx = (int64_t)x[i] + (j & 1) * ee;
                int64_t cy = (int64_t)y[i] + ((j >> 1) & 1) * ee;
                int64_t cz = (int64_t)z[i] + ((j >> 2) & 1) * ee;
                if (cx > fx - 1) cx = fx - 1;
                if (cy > fy - 1) cy = fy - 1;
                if (cz > fz - 1) cz = fz - 1;
                interleave_one((uint32_t)cx, (uint32_t)cy,
                               (uint32_t)cz,
                               &hi[i * 8 + j], &lo[i * 8 + j]);
            }
        }
    });
}

}  // extern "C"
