from spark_rapids_jni_tpu_torch.parallel.shuffle import quantized_rows

__all__ = ["quantized_rows"]
