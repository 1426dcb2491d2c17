// The flash backward's bias and ALiBi instances (bf16 and f32), compiled
// from flash_attention_bwd.cu in a translation unit of their own, so that
// nvcc builds them beside the instances without the terms.
#define TE_FLASH_UNIT 1
#include "flash_attention_bwd.cu"
