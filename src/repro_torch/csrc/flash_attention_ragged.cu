// The flash-attention kernel's ragged load path (any head dim 1-256, or
// storage off a 16-byte boundary; decode_attention.cuh): the instances
// flash_attention.cu leaves to this object, which nvcc compiles in
// parallel with it.  Its one entry, repro_flash_attention_ragged, is
// called by repro_flash_attention.
#define REPRO_RAGGED_PART
#include "flash_attention.cu"
