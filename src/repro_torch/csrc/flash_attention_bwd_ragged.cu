// The flash-attention backward's bf16 instances on the ragged load path
// (any head dim 1-256, or storage off a 16-byte boundary): the instances
// flash_attention_bwd.cu leaves to this object, which nvcc compiles in
// parallel with it.  Its one entry, repro_flash_attention_bwd_ragged, is
// called by repro_flash_attention_bwd.
#define REPRO_RAGGED_PART
#include "flash_attention_bwd.cu"
