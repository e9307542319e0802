// P5: kernel #3's keys scored from the TRANSPOSED bit matrix words_T
// [num_words, n_pad] (pack_t.cu), each row decoded once for all query
// tiles.
//
// Replaces scripts/probe_scorer_variants.py `acc_v3` (pallas_call in
// `run_transposed`), the TPU probe's scorer over words_T, which extracted
// two bit planes a shift with pltpu.bitcast and fed them to the matrix
// unit against pair-interleaved queries scaled by 1/2 (an artifact of the
// bitcast). This kernel takes the ordinary query operand qT [VP, b_pad]
// bf16 and computes #3's function (bucketed.cu): each row's score spliced
// with its local row id, (bits(max(score, 0)) & ~1023) | (row % 1024),
// rows >= num_rows INT32_MIN, each 1024-row block max-folded to kb = 1024 /
// bucket slots (local rows l and l' share slot l % kb). Its keys equal
// #3's gather form bit for bit for any weights: each query sums its row's
// ids sequentially in f32 from +0, in word order, then bit order.
//
// Bound on the H100 (the function's, bitpack.score_bounds): one f32 add a
// set bit and query at 67 TFLOP/s, or the words read once at 3.35 TB/s.
// At the probe's 2,000,000 rows of ~119 ids and B = 1,024 that is 3.644
// ms of adds (2.45 ms of bytes). What a design without tensor cores meets
// in practice is larger: every (id, query) weight comes from qT, about
// 488 GB of 64-byte gathers through L2 at that shape (qT is 64 MiB, more
// than the 50 MB L2, and no row shares its ids with a neighbour), beside
// 244 G f32 adds, each with a bf16 unpack.
//
// Design (bucketed_t.cuh holds the code). The first port of P5 tiled the
// queries along the grid's y axis, so each of the 32 query tiles re-read
// the 8 GB of words_T and re-decoded every row (~78 ms of bytes alone).
// Here a CTA owns 256 rows of one 1024-row block and no query axis: it
// reads their words once, coalesced along rows with an evict-first hint
// (__ldcs), decodes each row once into a list of u16 vocab ids in dynamic
// shared memory (`cap` = 192 ids a row: 96 KB, two CTAs an SM), and keeps
// the lists while it sweeps every tile of 32 queries. A row longer than
// its list keeps where its decode stopped and walks the rest of its words
// after the list on each pass, which keeps the order (counted in
// state[1]). In a pass, four lanes share a row and each loads 16 bytes of
// qT an id, so a warp load of the gathers touches 8 lines, not 32; the
// resident CTAs sweep the tiles in step (state[0], the pass clock), so
// the card reads one 2 MiB tile of qT at a time and it stays in L2; the
// 8 members of a bucket-8 slot lie in one lane's rows and its neighbour's,
// so the fold is in registers and one shuffle, with no barrier. What is
// left is the gathers through L2 and the adds.
#include "bucketed_t.cuh"

VS_KEYS_T_ENTRY(vs_bucketed_keys_t, false)
