"""Integer, bit and float helpers (PyTorch port of ``utils/``): 128- and
256-bit integer arithmetic for DECIMAL128, Arrow validity bitmasks and IEEE
bit patterns.  Every helper is elementwise torch on the tensors' device."""

from spark_rapids_jni_tpu_torch.utils import bitmask, floatbits, int128, int256

__all__ = ["bitmask", "floatbits", "int128", "int256"]
