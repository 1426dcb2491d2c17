// The flash forward's soft-cap instances (bf16 and f32), compiled from
// flash_attention.cu in a translation unit of their own, so that nvcc
// builds them beside the other instances.
#define TE_FLASH_UNIT 3
#include "flash_attention.cu"
