// The whole int8 ResBlock kernel of csrc/resblock_q.cu for f32 activations
// (x, skip, film, mid and out in f32): the same source with its f32
// instantiations, built into a library of its own beside the bf16 one, so
// that the two nvcc runs go in parallel. vd_resblock_q here takes dtype 1
// and refuses 0.
#define VD_RESBLOCK_F32 1
#include "resblock_q.cu"
