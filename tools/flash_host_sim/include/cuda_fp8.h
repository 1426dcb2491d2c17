// Stands in for the CUDA header of this name: see cuda_shim.h.
#include "cuda_shim.h"
