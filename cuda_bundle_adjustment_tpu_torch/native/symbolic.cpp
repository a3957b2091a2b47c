// Host symbolic analysis of the Schur-complement structure, in C++.
//
// Enumerates, per landmark, every ordered pair (i <= j) of its observing
// both-free edges: the multiply plan of the Schur complement
//   Hsc(p_i, p_j) -= Hpl(e_i) inv(Hll) Hpl(e_j)^T,
// indexes the Hsc block pattern over the Pa^2 key space and emits the
// triples sorted by target block, with the per-block offsets kernel B6
// walks.  Also the stable counting sort of the segment plans
// (solver/segments.py) and the O(E) pose-bandwidth bound of the RCM
// pre-check (solver/ordering.py).
//
// Every sort here is a counting sort over a known key range, so the pass is
// linear in the edges, the triples and the Pa^2 table:
//   tba_structure_count  masks the both-free edges, counting-sorts them by
//                        landmark (edge order within a landmark), orders each
//                        landmark's group by (pose, edge id), and counts the
//                        triples of every Hsc block;
//   tba_structure_emit   indexes the blocks row-major and writes each triple
//                        straight into its block's next slot.
// The JAX package's native/symbolic.cpp does the same job in other steps (a
// numpy lexsort of the edges, then int64 pair keys it indexes and sorts); this
// file is no longer a copy of it, but its output arrays are the same element
// for element: within a target block the triples come in enumeration order,
// and a pair of distinct edges on one pose emits its swapped copy right after
// it.  tba_pose_band_bound is still the JAX package's native/layout.cpp one.
//
// The Python binding (solver/native_symbolic.py) validates what it can
// before the call and owns all memory.  native/build.py builds this file with
// g++ at first use.

#include <cstdint>

namespace {

// A both-free edge in its landmark's group: its pose in the high 32 bits and
// its edge id in the low 32, so ordering the values orders by (pose, edge id).
inline int64_t pose_of(int64_t v) { return v >> 32; }
inline int32_t edge_of(int64_t v) { return static_cast<int32_t>(v & 0xffffffff); }

}  // namespace

extern "C" {

// Pass 1.  For the E edges (pose_idx, lm_idx), Pa free poses and La free
// landmarks: refuse a negative id (returns -1, the outputs unfinished), mask
// the both-free edges (pose < Pa and landmark < La), counting-sort them by
// landmark into group (start[l] .. start[l + 1] holds landmark l's edges),
// insertion-sort each group by (pose, edge id): exactly np.lexsort((eid,
// pose, landmark)) of the JAX package's pass.  Then enumerate every pair
// (a <= b) of a group, with a swapped copy of each pair of distinct edges on
// one pose, and count the triples of each key p_a * Pa + p_b in table.
//
// start [La + 1] and table [Pa * Pa] must come in zeroed; group holds E
// values, E < 2^31 (the edge ids are packed in 32 bits).  out = {triples T,
// stored blocks nnz} (the Pa diagonal blocks are always stored).  Returns 0.
int64_t tba_structure_count(
    const int64_t* pose_idx,
    const int64_t* lm_idx,
    int64_t E,
    int64_t Pa,
    int64_t La,
    int64_t* start,   // [La + 1], zeroed
    int64_t* group,   // [E]
    uint32_t* table,  // [Pa * Pa], zeroed: triples a key
    int64_t* out)     // [2]
{
    for (int64_t e = 0; e < E; ++e)
    {
        const int64_t p = pose_idx[e];
        const int64_t l = lm_idx[e];
        if (p < 0 || l < 0)
        {
            return -1;
        }
        if (p < Pa && l < La)
        {
            ++start[l + 1];
        }
    }
    for (int64_t l = 0; l < La; ++l)
    {
        start[l + 1] += start[l];
    }
    // scatter in edge order with start[l] as the cursor, then shift back
    for (int64_t e = 0; e < E; ++e)
    {
        const int64_t p = pose_idx[e];
        const int64_t l = lm_idx[e];
        if (p < Pa && l < La)
        {
            group[start[l]++] = (p << 32) | e;
        }
    }
    for (int64_t l = La; l > 0; --l)
    {
        start[l] = start[l - 1];
    }
    start[0] = 0;

    int64_t T = 0;
    for (int64_t l = 0; l < La; ++l)
    {
        const int64_t b = start[l];
        const int64_t e = start[l + 1];
        // groups are short (a track's observations): insertion sort
        for (int64_t a = b + 1; a < e; ++a)
        {
            const int64_t v = group[a];
            int64_t c = a;
            while (c > b && group[c - 1] > v)
            {
                group[c] = group[c - 1];
                --c;
            }
            group[c] = v;
        }
        int64_t run_end = b;  // end of the run of a's pose
        for (int64_t a = b; a < e; ++a)
        {
            const int64_t pa = pose_of(group[a]);
            uint32_t* row = table + pa * Pa;
            for (int64_t c = a; c < e; ++c)
            {
                ++row[pose_of(group[c])];
            }
            if (run_end <= a)
            {
                for (run_end = a + 1; run_end < e && pose_of(group[run_end]) == pa; ++run_end)
                {
                }
            }
            // the swapped copies of a's pairs with the later edges on its pose
            row[pa] += static_cast<uint32_t>(run_end - a - 1);
            T += (e - a) + (run_end - a - 1);
        }
    }
    int64_t nnz = 0;
    for (int64_t r = 0; r < Pa; ++r)
    {
        const uint32_t* row = table + r * Pa;
        for (int64_t c = r + 1; c < Pa; ++c)
        {
            nnz += row[c] != 0;
        }
    }
    out[0] = T;
    out[1] = nnz + Pa;
    return 0;
}

// Pass 2, over tba_structure_count's start, group and table.  Indexes the
// stored blocks row-major (upper triangle, every diagonal): blk_row, blk_col,
// rowptr [Pa + 1] (a row's first block), diag_pos [Pa]; the per-block offsets
// of the triples [nnz + 1]; then enumerates the pairs again in the same order
// and writes each (e_i, e_j) into its block's next slot, so a block's triples
// keep enumeration order.  tri_k [T] is each slot's block.
void tba_structure_emit(
    const int64_t* start,
    const int64_t* group,
    int64_t La,
    int64_t Pa,
    int32_t* table,     // [Pa * Pa]: counts in, block positions out
    int64_t* rowptr,    // [Pa + 1]
    int32_t* blk_row,   // [nnz]
    int32_t* blk_col,   // [nnz]
    int32_t* diag_pos,  // [Pa]
    int64_t* offsets,   // [nnz + 1]
    int32_t* tri_ei,    // [T]
    int32_t* tri_ej,    // [T]
    int32_t* tri_k)     // [T]
{
    int64_t nnz = 0;
    int64_t run = 0;
    for (int64_t r = 0; r < Pa; ++r)
    {
        rowptr[r] = nnz;
        int32_t* row = table + r * Pa;
        for (int64_t c = r; c < Pa; ++c)
        {
            const int64_t count = static_cast<uint32_t>(row[c]);
            if (count > 0 || c == r)
            {
                blk_row[nnz] = static_cast<int32_t>(r);
                blk_col[nnz] = static_cast<int32_t>(c);
                offsets[nnz] = run;
                run += count;
                row[c] = static_cast<int32_t>(nnz++);
            }
        }
        diag_pos[r] = row[r];
    }
    rowptr[Pa] = nnz;
    offsets[nnz] = run;

    // offsets[k] is block k's cursor here, then shifted back
    for (int64_t l = 0; l < La; ++l)
    {
        const int64_t b = start[l];
        const int64_t e = start[l + 1];
        int64_t run_end = b;
        for (int64_t a = b; a < e; ++a)
        {
            const int64_t pa = pose_of(group[a]);
            const int32_t ea = edge_of(group[a]);
            const int32_t* row = table + pa * Pa;
            if (run_end <= a)
            {
                for (run_end = a + 1; run_end < e && pose_of(group[run_end]) == pa; ++run_end)
                {
                }
            }
            // the diagonal block: (a, a), then each later edge c on a's pose
            // as (a, c) and its swapped copy (c, a)
            int64_t o = offsets[row[pa]];
            tri_ei[o] = ea;
            tri_ej[o] = ea;
            ++o;
            for (int64_t c = a + 1; c < run_end; ++c)
            {
                const int32_t ec = edge_of(group[c]);
                tri_ei[o] = ea;
                tri_ej[o] = ec;
                tri_ei[o + 1] = ec;
                tri_ej[o + 1] = ea;
                o += 2;
            }
            offsets[row[pa]] = o;
            for (int64_t c = run_end; c < e; ++c)
            {
                const int64_t k = row[pose_of(group[c])];
                o = offsets[k]++;
                tri_ei[o] = ea;
                tri_ej[o] = edge_of(group[c]);
            }
        }
    }
    for (int64_t k = nnz; k > 0; --k)
    {
        offsets[k] = offsets[k - 1];
    }
    offsets[0] = 0;
    for (int64_t k = 0; k < nnz; ++k)
    {
        for (int64_t o = offsets[k]; o < offsets[k + 1]; ++o)
        {
            tri_k[o] = static_cast<int32_t>(k);
        }
    }
}

// ---------------------------------------------------------------------------
// Stable counting sort of n segment ids into nseg segments: order [n] lists
// the rows of segment 0, then 1, ..., each in row order, and offsets
// [nseg + 1] bounds them (np.argsort(ids, kind="stable") and
// np.searchsorted(sorted, arange(nseg + 1))).  Rows with ids >= nseg (fixed
// vertices) are left out.  offsets must come in zeroed.  Returns the rows
// kept (offsets[nseg]), or -1 for a negative id, before order is written.
int64_t tba_counting_sort(
    const int64_t* ids, int64_t n, int64_t nseg, int64_t* offsets /* [nseg + 1] */,
    int64_t* order /* [n] */)
{
    for (int64_t i = 0; i < n; ++i)
    {
        const int64_t s = ids[i];
        if (s < 0)
        {
            return -1;
        }
        if (s < nseg)
        {
            ++offsets[s + 1];
        }
    }
    for (int64_t s = 0; s < nseg; ++s)
    {
        offsets[s + 1] += offsets[s];
    }
    for (int64_t i = 0; i < n; ++i)
    {
        const int64_t s = ids[i];
        if (s < nseg)
        {
            order[offsets[s]++] = i;
        }
    }
    for (int64_t s = nseg; s > 0; --s)
    {
        offsets[s] = offsets[s - 1];
    }
    offsets[0] = 0;
    return offsets[nseg];
}

// ---------------------------------------------------------------------------
// O(E) pose-bandwidth bound (solver/ordering.py plan_pose_order's cheap
// pre-check): bw = max over landmarks of (max observing pose - min observing
// pose) among both-free edges.  One sequential pass.
int64_t tba_pose_band_bound(
    const int64_t* pose_idx, const int64_t* lm_idx, int64_t E,
    int64_t Pa, int64_t La,
    int64_t* pmin /* scratch [La] */, int64_t* pmax /* scratch [La] */)
{
    for (int64_t l = 0; l < La; ++l)
    {
        pmin[l] = Pa;
        pmax[l] = -1;
    }
    for (int64_t e = 0; e < E; ++e)
    {
        const int64_t p = pose_idx[e];
        const int64_t l = lm_idx[e];
        if (p < Pa && l < La)
        {
            if (p < pmin[l])
            {
                pmin[l] = p;
            }
            if (p > pmax[l])
            {
                pmax[l] = p;
            }
        }
    }
    int64_t bw = 0;
    for (int64_t l = 0; l < La; ++l)
    {
        if (pmax[l] >= 0 && pmax[l] - pmin[l] > bw)
        {
            bw = pmax[l] - pmin[l];
        }
    }
    return bw;
}

}  // extern "C"
