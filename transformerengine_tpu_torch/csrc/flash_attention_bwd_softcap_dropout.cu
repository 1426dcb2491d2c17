// The flash backward's soft-cap instances with dropout (bf16 and f32),
// compiled from flash_attention_bwd.cu in a translation unit of their own,
// so that nvcc builds them beside the other instances.
#define TE_FLASH_UNIT 4
#include "flash_attention_bwd.cu"
