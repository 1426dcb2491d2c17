"""The input pipeline: token-bin datasets, sequence packing and a
prefetching loader (a C++ runtime through ctypes; see csrc/packer.cpp)."""
from .loader import (PackedDataLoader, native_available, pack_sequences,
                     read_token_bin, write_token_bin)
