// Kernel #3 in the plane form: fused scoring + bucketed candidate keys of
// dense rows, on the tensor cores.
//
// Replaces vsearch_tpu/ops/bitpack.py `_make_bucketed_kernel` (pallas_call
// in `_bucketed_keys`) for rows at or above the crossover width in
// matrices of enough rows to fill the card (bitpack.row_form); bucketed.cu
// keeps the others. The keys
// are bucketed.cu's: (bits(max(score, 0)) & ~1023) | (row % 1024), rows >=
// num_rows INT32_MIN, each 1024-row block max-folded to kb = 1024 / bucket
// slots, local rows l and l' sharing slot l % kb. The row core is
// planes.cuh `plane_rows` (its note gives the design).
//
// The fold: `split` CTAs share a 1024-row block (bitpack.plane_geometry:
// 1 once there are enough blocks to fill the card, up to 4 on small
// indexes), each running 4 / split passes of 256 rows. A pass's keys go to
// the CTA's kb x 32 slots in shared memory (atomicMax: integer, so the
// order does not matter), and after its last pass the CTA writes them
// once, or, where the block is split, max-folds them into keys prefilled
// with INT32_MIN (atomicMax in device memory). Only the keys reach device
// memory.
#include "bucketed_plane.cuh"

// words [n_pad, num_words] uint32 (n_pad % 1024 == 0, num_words % 128 ==
// 0, 16-byte aligned), qI [b_pad / 32, 2 * nplanes, 4 KB]
// (bitpack._plane_operand), keys [n_pad / bucket, b] int32 (prefilled
// with INT32_MIN when split > 1) with kb = 1024 / bucket. nplanes (even),
// grid_x and split come from `plane_geometry`. Returns a cudaError_t.
VS_BUCKETED_PLANE_ENTRY(vs_bucketed_keys_plane, bucketed_plane_kernel,
                        vs::kPlaneShipped)
