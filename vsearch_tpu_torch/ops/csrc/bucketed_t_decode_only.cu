// Timing probe of P5 (bucketed_t.cu), for
// vsearch_tpu_torch/scripts/probe_scorer_variants.py: the shipped kernel
// with its sweep's gathers and adds dropped. It reads words_T and decodes
// every row into its list as the shipped kernel does, then for each query
// tile stores keys made from the lists' counts, without reading qT. What
// the shipped kernel takes beyond it is the cost of the gathers through L2
// and the f32 adds.
//
// TIMING ONLY: it does not compute the function. Its keys are never
// compared with anything or used; no search path calls it.
#include "bucketed_t.cuh"

// the arguments of vs_bucketed_keys_t (bucketed_t.cu)
VS_KEYS_T_ENTRY(vs_bucketed_keys_t_decode_only, true)
