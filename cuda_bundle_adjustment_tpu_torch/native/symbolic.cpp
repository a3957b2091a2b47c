// Host symbolic analysis of the Schur-complement structure, in C++.
//
// Enumerates, per landmark, every ordered pair (i <= j) of its observing
// both-free edges: the multiply plan of the Schur complement
//   Hsc(p_i, p_j) -= Hpl(e_i) inv(Hll) Hpl(e_j)^T,
// indexes the Hsc block pattern by a counting pass over the Pa^2 key space
// and emits the triples counting-sorted by target block, with the per-block
// offsets kernel B6 walks.  Also the O(E) pose-bandwidth bound of the RCM
// pre-check (solver/ordering.py).
//
// A copy of the JAX package's native/symbolic.cpp (tba_count_pairs,
// tba_enumerate_pairs, tba_index_pairs_count, tba_emit_sorted,
// tba_index_pairs_emit) and native/layout.cpp (tba_pose_band_bound), kept
// statement for statement, emission order included: within a target block
// the triples come in enumeration order, and a pair of distinct edges on one
// pose emits its swapped copy right after it.
//
// Inputs are pre-sorted by (landmark, pose, edge id); the Python binding
// (solver/native_symbolic.py) sorts with numpy, validates and owns all
// memory.  native/build.py builds this file with g++ at first use.

#include <cstdint>

extern "C" {

// Count pairs sum_g n_g*(n_g+1)/2 over contiguous groups of equal landmark id,
// plus one extra per same-pose distinct-edge pair (diagonal blocks need both
// multiply orders since densification does not mirror them).
int64_t tba_count_pairs(const int64_t* pose_sorted, const int64_t* lm_sorted, int64_t n)
{
    int64_t total = 0;
    int64_t i = 0;
    while (i < n)
    {
        int64_t j = i + 1;
        while (j < n && lm_sorted[j] == lm_sorted[i])
        {
            ++j;
        }
        const int64_t g = j - i;
        total += g * (g + 1) / 2;
        // same-pose runs inside the (already pose-sorted) group
        int64_t a = i;
        while (a < j)
        {
            int64_t b = a + 1;
            while (b < j && pose_sorted[b] == pose_sorted[a])
            {
                ++b;
            }
            const int64_t r = b - a;
            total += r * (r - 1) / 2;  // swapped copies of distinct-edge pairs
            a = b;
        }
        i = j;
    }
    return total;
}

// Emit pair keys (p_i * Pa + p_j) and the edge-id pairs, in group order.
void tba_enumerate_pairs(
    const int64_t* eid_sorted,
    const int64_t* pose_sorted,
    const int64_t* lm_sorted,
    int64_t n,
    int64_t Pa,
    int64_t* out_pair_keys,
    int64_t* out_tri_ei,
    int64_t* out_tri_ej)
{
    int64_t out = 0;
    int64_t i = 0;
    while (i < n)
    {
        int64_t j = i + 1;
        while (j < n && lm_sorted[j] == lm_sorted[i])
        {
            ++j;
        }
        for (int64_t a = i; a < j; ++a)
        {
            const int64_t pa = pose_sorted[a];
            const int64_t ea = eid_sorted[a];
            for (int64_t b = a; b < j; ++b)
            {
                out_pair_keys[out] = pa * Pa + pose_sorted[b];
                out_tri_ei[out] = ea;
                out_tri_ej[out] = eid_sorted[b];
                ++out;
                if (b != a && pose_sorted[b] == pa)
                {
                    // diagonal block: also emit the swapped order
                    out_pair_keys[out] = pa * Pa + pa;
                    out_tri_ei[out] = eid_sorted[b];
                    out_tri_ej[out] = ea;
                    ++out;
                }
            }
        }
        i = j;
    }
}

// Index the Hsc block pattern from raw pair keys in O(T + Pa^2) via a
// counting pass over the dense key space (keys = p1*Pa + p2 < Pa^2, which is
// ~2M for KITTI-scale pose counts — cheaper than any comparison sort).
// Replaces np.unique + np.searchsorted over the T ~ 1.7M multiply triples.
//
// Pass 1 (tba_index_pairs_count): mark present keys (pairs + all diagonals),
//   fill pos[key] = running unique index, return nnz.
// Pass 2 (tba_index_pairs_emit): emit blk_row/col per unique key, diag_pos,
//   and tri_k[i] = pos[pair_keys[i]].
int64_t tba_index_pairs_count(
    const int64_t* pair_keys,
    int64_t T,
    int64_t Pa,
    int32_t* pos /* size Pa*Pa, scratch+output */)
{
    const int64_t n_keys = Pa * Pa;
    for (int64_t k = 0; k < n_keys; ++k)
    {
        pos[k] = 0;
    }
    for (int64_t i = 0; i < T; ++i)
    {
        pos[pair_keys[i]] = 1;
    }
    for (int64_t p = 0; p < Pa; ++p)
    {
        pos[p * Pa + p] = 1;  // diagonal blocks always stored
    }
    int64_t nnz = 0;
    for (int64_t k = 0; k < n_keys; ++k)
    {
        if (pos[k])
        {
            pos[k] = static_cast<int32_t>(nnz++);
        }
        else
        {
            pos[k] = -1;
        }
    }
    return nnz;
}

// Counting-sort emission: given the pos[] map from tba_index_pairs_count,
// rewrite the triples sorted by target block (tri_k ascending, enumeration
// order within a block) and emit the per-block rowptr.  Spares the host a
// 1.7M-element argsort of the triples.
void tba_emit_sorted(
    const int64_t* pair_keys,
    const int64_t* tri_ei,
    const int64_t* tri_ej,
    int64_t T,
    int64_t Pa,
    const int32_t* pos,
    int64_t nnz,
    int64_t* rowptr,     // [nnz + 1]
    int32_t* out_ei,     // [T]
    int32_t* out_ej,     // [T]
    int32_t* out_k)      // [T]
{
    for (int64_t k = 0; k <= nnz; ++k)
    {
        rowptr[k] = 0;
    }
    for (int64_t i = 0; i < T; ++i)
    {
        ++rowptr[pos[pair_keys[i]] + 1];
    }
    for (int64_t k = 0; k < nnz; ++k)
    {
        rowptr[k + 1] += rowptr[k];
    }
    // cursor pass (restore rowptr afterwards by shifting)
    for (int64_t i = 0; i < T; ++i)
    {
        const int32_t k = pos[pair_keys[i]];
        const int64_t o = rowptr[k]++;
        out_ei[o] = static_cast<int32_t>(tri_ei[i]);
        out_ej[o] = static_cast<int32_t>(tri_ej[i]);
        out_k[o] = k;
    }
    for (int64_t k = nnz; k > 0; --k)
    {
        rowptr[k] = rowptr[k - 1];
    }
    rowptr[0] = 0;
}

void tba_index_pairs_emit(
    const int64_t* pair_keys,
    int64_t T,
    int64_t Pa,
    const int32_t* pos,
    int32_t* out_tri_k,     // [T]
    int32_t* out_blk_row,   // [nnz]
    int32_t* out_blk_col,   // [nnz]
    int32_t* out_diag_pos)  // [Pa]
{
    for (int64_t i = 0; i < T; ++i)
    {
        out_tri_k[i] = pos[pair_keys[i]];
    }
    const int64_t n_keys = Pa * Pa;
    for (int64_t k = 0; k < n_keys; ++k)
    {
        const int32_t p = pos[k];
        if (p >= 0)
        {
            out_blk_row[p] = static_cast<int32_t>(k / Pa);
            out_blk_col[p] = static_cast<int32_t>(k % Pa);
        }
    }
    for (int64_t p = 0; p < Pa; ++p)
    {
        out_diag_pos[p] = pos[p * Pa + p];
    }
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
