// Timing probe of kernel #3's plane form (bucketed_plane.cu), for
// vsearch_tpu_torch/scripts/probe_scorer_variants.py: the Hopper
// counterpart of scripts/probe_scorer_variants.py's two-accumulator
// variant (`acc_v0(..., twoacc=True)`), which asked whether the TPU
// overlapped plane extraction with its matrix unit. This instantiation of
// the pass (planes.cuh `kPlaneOperandOnly`) loads every word of the rows
// as the shipped pass does but builds no fragments (it multiplies one
// fixed pair), so the words stream from device memory and the query
// operand through the ring: what the shipped pass takes beyond it is the
// cost of building fragments.
//
// TIMING ONLY: it does not compute the function. Its keys are never
// compared with anything or used; no search path calls it.
#include "bucketed_plane.cuh"

// the arguments of vs_bucketed_keys_plane (bucketed_plane.cu)
VS_BUCKETED_PLANE_ENTRY(vs_plane_operand_only, plane_operand_only_kernel,
                        vs::kPlaneOperandOnly)
