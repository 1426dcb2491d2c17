from .dtypes import dtype_max, float8_e4m3, is_fp8_dtype
from .prequant import (PrequantizedKernel, prequantize_kernel_array,
                       prequantize_kernels)
from .qmath import (compute_amax, compute_scale_from_amax,
                    current_scale_quantize, saturate_cast)
from .quantizer import CurrentScaleQuantizer, QuantizeLayout
from .tensor import ScaledTensor1x
