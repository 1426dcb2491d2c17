// The flash backward's dropout instances (bf16 and f32, with the bias and
// ALiBi terms), compiled from flash_attention_bwd.cu in a translation unit
// of their own, so that nvcc builds them beside the other instances.
#define TE_FLASH_UNIT 2
#include "flash_attention_bwd.cu"
