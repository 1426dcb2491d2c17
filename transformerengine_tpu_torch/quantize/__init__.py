from .dtypes import dtype_max, float8_e4m3, is_fp8_dtype
from .grouped import (GroupedKernelTensor, GroupedQuantizer,
                      GroupedScaledTensor, grouped_gemm_scaled)
from .helper import QuantizerFactory, autocast
from .microbatch import (GroupedQDQKernel, KernelCache, QDQKernel,
                         quantize_grouped_kernel, quantize_kernel)
from .prequant import (PrequantizedKernel, prequantize_kernel_array,
                       prequantize_kernels)
from .qmath import (block_quantize, compute_amax, compute_scale_from_amax,
                    current_scale_quantize, saturate_cast, stochastic_cast)
from .quantizer import (BlockScaleQuantizer, CurrentScaleQuantizer,
                        DelayedScaleQuantizer, NVFP4Quantizer, QuantizeLayout,
                        QuantizerSet)
from .scaling_modes import ScalingMode
from .tensor import ScaledTensor1x, ScaledTensor2x
