// The flash forward's dropout instances (bf16 and f32, with the bias and
// ALiBi terms, and e4m3 Q/K/V payloads with any O), compiled from
// flash_attention.cu in a translation unit of their own, so that nvcc
// builds them beside the other instances.
#define TE_FLASH_UNIT 2
#include "flash_attention.cu"
