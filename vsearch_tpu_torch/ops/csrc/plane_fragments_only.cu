// Timing probe of kernel #3's plane form (bucketed_plane.cu), for
// vsearch_tpu_torch/scripts/probe_scorer_variants.py: the other half of
// plane_operand_only.cu's question. This instantiation of the pass
// (planes.cuh `kPlaneFragmentsOnly`) fills the ring of operand slices once
// and multiplies the same slices again, so only the fragments are built
// (the rows' words still stream from device memory): what the shipped
// pass takes beyond it is the cost of the operand's re-reads from L2.
//
// TIMING ONLY: it does not compute the function. Its keys are never
// compared with anything or used; no search path calls it.
#include "bucketed_plane.cuh"

// the arguments of vs_bucketed_keys_plane (bucketed_plane.cu)
VS_BUCKETED_PLANE_ENTRY(vs_plane_fragments_only, plane_fragments_only_kernel,
                        vs::kPlaneFragmentsOnly)
