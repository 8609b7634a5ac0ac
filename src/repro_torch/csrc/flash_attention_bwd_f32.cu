// The flash-attention backward's f32 instances on the aligned load path:
// the instances flash_attention_bwd.cu leaves to this object, which nvcc
// compiles in parallel with it.  Its one entry,
// repro_flash_attention_bwd_f32, is called by repro_flash_attention_bwd.
#define REPRO_F32_PART
#include "flash_attention_bwd.cu"
